"""The port's map-table scans (`multicol_slam_tpu_torch/native.py`, the g++
build of `csrc/mapops.cpp`): the C library == its numpy versions == the JAX
package's `native`, exactly (integer counts and slot lists)."""
import numpy as np
import pytest

from multicol_slam_tpu import native as jnative
from multicol_slam_tpu_torch import native

P = 40


def random_table(seed, K=12, F=60):
    rng = np.random.default_rng(seed)
    kf_point = np.full((K, F), -1, np.int32)
    fill = rng.random((K, F)) < 0.6
    kf_point[fill] = rng.integers(0, P, fill.sum())
    kf_octave = rng.integers(0, 4, (K, F)).astype(np.int32)
    kf_valid = np.ones(K, bool)
    kf_valid[rng.integers(0, K, 2)] = False
    return kf_point, kf_octave, kf_valid


def test_library_builds_into_the_package():
    lib = native._LIBRARY.build()
    assert lib.is_file() and lib.parent == native.BUILD_DIR
    assert native.SOURCE.is_file()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_covisibility_counts(seed):
    kf_point, _, kf_valid = random_table(seed)
    for k in range(kf_point.shape[0]):
        got = native.covisibility_counts(kf_point, kf_valid, k, P)
        np.testing.assert_array_equal(got, native.covisibility_counts_plain(kf_point, kf_valid, k, P))
        np.testing.assert_array_equal(got, jnative.covisibility_counts(kf_point, kf_valid, k, n_points=P))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_covisibility_counts_hash_probe(seed):
    """tests/test_native.py's call, three arguments: the hash-probe scan
    (no point-id capacity) == its numpy version == the JAX package's."""
    kf_point, _, kf_valid = random_table(seed)
    kf_point[0, :3] = [P + 5, 2 * P, P + 5]   # ids past any capacity still count
    kf_point[1, :2] = [P + 5, 2 * P]
    for k in range(kf_point.shape[0]):
        got = native.covisibility_counts(kf_point, kf_valid, k)
        np.testing.assert_array_equal(got, native.covisibility_counts_plain(kf_point, kf_valid, k))
        np.testing.assert_array_equal(got, jnative.covisibility_counts(kf_point, kf_valid, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vote_counts(seed):
    kf_point, _, kf_valid = random_table(seed)
    seeds = np.random.default_rng(seed + 10).choice(P, 12, replace=False)
    got = native.vote_counts(kf_point, kf_valid, seeds, P)
    np.testing.assert_array_equal(got, native.vote_counts_plain(kf_point, kf_valid, seeds, P))
    np.testing.assert_array_equal(got, jnative.vote_counts(kf_point, kf_valid, seeds, P))


@pytest.mark.parametrize("expected", [0, 5, 10_000], ids=["undersized", "small", "oversized"])
def test_find_slots(expected):
    """Any buffer size gives every slot, in row-major order."""
    kf_point, _, kf_valid = random_table(3)
    ids = np.array([1, 7, 8, 30])
    got = native.find_slots(kf_point, kf_valid, ids, P, expected_hits=expected)
    for want in (native.find_slots_plain(kf_point, kf_valid, ids, P),
                 jnative.find_slots(kf_point, kf_valid, ids, P, expected_hits=expected)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_redundancy_counts(seed):
    kf_point, kf_octave, kf_valid = random_table(seed)
    for j in np.nonzero(kf_valid)[0][:4]:
        got = native.redundancy_counts(kf_point, kf_octave, kf_valid, int(j))
        np.testing.assert_array_equal(got, native.redundancy_counts_plain(kf_point, kf_octave, kf_valid, int(j)))
        np.testing.assert_array_equal(got, jnative.redundancy_counts(kf_point, kf_octave, kf_valid, int(j)))
