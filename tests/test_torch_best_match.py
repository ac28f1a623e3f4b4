"""Port parity: the plain best-match (`masked_best_match_cams_plain`, the
CUDA kernel's CPU version) against the reference TPU kernel
`masked_best_match_pallas_cams` run in interpret mode, and against the
reference's jnp oracle. All four outputs must be exactly equal: distances
are exact (half-)integers and the tie rules are part of the contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops.pallas_match import (
    masked_best_match_pallas_cams, masked_best_match_reference,
)
from multicol_slam_tpu_torch.ops.best_match import (
    KERNEL, masked_best_match_cams, masked_best_match_cams_plain,
)

B = 32
NAMES = ("best", "second", "idx", "col_best")


def _problem(seed, C, Q, T, shared=False, masked=False, ties=False, frac_t=0.8, B=B):
    rng = np.random.default_rng(seed)
    if ties:  # four distinct descriptors on a coarse pixel grid: many equal distances
        pool = rng.integers(0, 256, (4, B), dtype=np.uint8)
        dq = pool[rng.integers(0, 4, (C, Q))]
        dt = pool[rng.integers(0, 4, (T,) if shared else (C, T))]
    else:
        dq = rng.integers(0, 256, (C, Q, B), dtype=np.uint8)
        dt = rng.integers(0, 256, (T, B) if shared else (C, T, B), dtype=np.uint8)
    uvq = rng.uniform(0, 300, (C, Q, 2)).astype(np.float32)
    uvt = rng.uniform(0, 300, (C, T, 2)).astype(np.float32)
    if ties:
        uvq, uvt = np.round(uvq / 16) * 16, np.round(uvt / 16) * 16
    p = dict(
        desc_q=dq, uv_q=uvq, oct_q=rng.integers(0, 4, (C, Q)).astype(np.int32),
        desc_t=dt, uv_t=uvt,
        rad_t=np.where(rng.uniform(size=(C, T)) < frac_t, rng.uniform(10, 80, (C, T)), -1.0).astype(np.float32),
        lvl_t=rng.integers(0, 4, (C, T)).astype(np.float32),
        rad_q=np.where(rng.uniform(size=(C, Q)) < 0.9, 1e9, -1.0).astype(np.float32),
    )
    if masked:
        p["mask_q"] = rng.integers(0, 256, dq.shape, dtype=np.uint8)
        p["mask_t"] = rng.integers(0, 256, dt.shape, dtype=np.uint8)
    return p


CASES = {
    "plain": dict(seed=0, C=3, Q=64, T=600),
    "masked": dict(seed=1, C=3, Q=64, T=600, masked=True),
    "shared_desc_t": dict(seed=2, C=3, Q=64, T=600, shared=True),
    "shared_masked": dict(seed=3, C=3, Q=64, T=600, shared=True, masked=True),
    "ragged": dict(seed=4, C=3, Q=37, T=1001, shared=True),
    "one_camera": dict(seed=5, C=1, Q=64, T=700),
    "ties": dict(seed=6, C=3, Q=64, T=600, shared=True, ties=True),
    "ties_masked": dict(seed=7, C=2, Q=40, T=520, masked=True, ties=True),
    "all_disabled": dict(seed=8, C=3, Q=16, T=256, frac_t=0.0),
    "16_bytes": dict(seed=9, C=2, Q=40, T=300, shared=True, masked=True, B=16),
    "64_bytes": dict(seed=10, C=2, Q=40, T=300, B=64),
}


def _plain(p):
    out = masked_best_match_cams_plain(**{k: torch.tensor(v) for k, v in p.items()}, level_tol=1.0)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_tpu_kernel(case):
    p = _problem(**CASES[case])
    ref = masked_best_match_pallas_cams(**{k: jnp.asarray(v) for k, v in p.items()},
                                        level_tol=1.0, interpret=True)
    got = _plain(p)
    for name, a, b in zip(NAMES, got, ref):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{case}: {name}")
    if case == "all_disabled":
        assert (got[2] == -1).all() and (got[0] == 1e9).all() and (got[3] == 1e9).all()
    else:
        assert (got[2] >= 0).sum() > 10  # the case exercises real matches


@pytest.mark.parametrize("case", ["plain", "ragged", "one_camera", "ties"])
def test_plain_equals_reference_oracle(case):
    """Per camera against the reference's jnp oracle (best, second, idx)."""
    p = _problem(**CASES[case])
    got = _plain(p)
    for c in range(p["desc_q"].shape[0]):
        dt = p["desc_t"] if p["desc_t"].ndim == 2 else p["desc_t"][c]
        ref = masked_best_match_reference(
            jnp.asarray(p["desc_q"][c]), jnp.asarray(p["uv_q"][c]), jnp.asarray(p["oct_q"][c]),
            jnp.asarray(dt), jnp.asarray(p["uv_t"][c]), jnp.asarray(p["rad_t"][c]),
            jnp.asarray(p["lvl_t"][c]), rad_q=jnp.asarray(p["rad_q"][c]), level_tol=1.0)
        for name, a, b in zip(NAMES, got, ref):
            np.testing.assert_array_equal(a[c], np.asarray(b), err_msg=f"{case} cam {c}: {name}")


def test_wrapper_takes_plain_version_on_cpu():
    p = {k: torch.tensor(v) for k, v in _problem(**CASES["masked"]).items()}
    before = KERNEL.launches
    got = masked_best_match_cams(**p)
    ref = masked_best_match_cams_plain(**p)
    assert KERNEL.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)

