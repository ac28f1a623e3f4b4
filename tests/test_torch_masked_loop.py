"""The masked loop cell on the CPU, the port alone: chip_smoke.py's loop
phase's masked job (recipe (A) of tests/test_loop_reloc._drift_world, loops
on, mdBRIEF's learned masks with each oracle feature carrying its
landmark's seeded mask, a store that starts at 16 keyframes and 512 points)
through chip_smoke's own `masked_loop_run`, with the plain matcher (CPU
tensors). Held to the numbers that

    python tests/torch_masked_loop_reference.py

printed for the JAX package on the CPU under the RANSAC seeds 0, 1, 2
(chip_smoke.MASKED_LOOP_REF: frame 1, 134 tracked, 30 / 34 / 36
keyframes, 789 / 827 / 853 points, 1 loop, 5 / 7 / 5 `_try_close` calls,
each candidate matrix masked at 32, keyframe ATE 0.043846 / 0.070163 /
0.048557 m; at seed 0 the capacities grew to 32 keyframes and 1024
points) by chip_smoke.masked_loop_gates, the gates the card's run must
pass; and, on their own: the store's growth, the masked candidate
matrices at 32, the unmasked loop projections, the captured launches.
The instrumentation's stage timers synchronise the card:
`torch.cuda.synchronize` is a no-op for the run. ~90 s on one CPU thread.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.test_loop_reloc import _drift_world
from torch_mdbrief_masks import landmark_masks, masked_fields

JAX_CAPACITY = (32, 1024)   # the reference run's final capacities at seed 0


@pytest.fixture(scope="module")
def cell():
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dev = torch.device("cpu")
        boot = cs.loop_world(dev, "A", quiet=True, masked=True)
        yield boot, cs.masked_loop_run(dev, boot)
    finally:
        torch.set_num_threads(threads)
        mp.undo()


def test_features_are_the_reference_scripts(cell):
    """The port's masked frames are the ones the reference script feeds the
    JAX system (its world, its masks): the same slots, descriptors and
    masks exactly, pixels and rays within 1e-4 (float32 projections,
    tests/test_torch_synthetic.py's bounds)."""
    (world, feats, _), _ = cell
    jworld = _drift_world()
    masks = landmark_masks(jworld, seed=cs.MASKED_LOOP_MASK_SEED, keep=cs.MASKED_LOOP_KEEP)
    np.testing.assert_array_equal(world.descs, jworld.descs)
    for t in (0, 40, 134):
        want = masked_fields(jworld.frame_features(t), jworld, masks)
        for k, v in want.items():
            got = getattr(feats[t], k).numpy()
            if k in ("uv", "rays"):
                np.testing.assert_allclose(got, v, rtol=0, atol=1e-4, err_msg=f"frame {t} {k}")
            else:
                np.testing.assert_array_equal(got, v, err_msg=f"frame {t} {k}")
    assert (want["dmask"][want["valid"]] < 255).any()


def test_store_grows(cell):
    _, u = cell
    start = cs.MASKED_LOOP_MAP
    assert u["kf_capacity"] > start["max_keyframes"] and u["pt_capacity"] > start["max_points"]
    assert JAX_CAPACITY[0] > start["max_keyframes"] and JAX_CAPACITY[1] > start["max_points"]
    assert u["n_kf"] > start["max_keyframes"] and u["n_pt"] > start["max_points"]


def test_candidate_matrices_masked_at_32(cell):
    """Every `_try_close` candidate matrix is hamming_matrix_masked's, at
    TH_LOW x0.5 = 32 (the reference's 5 calls, each masked at 32)."""
    _, u = cell
    assert u["use_masks"] and u["try_close"] >= 1
    assert u["matrices"] and all(m == (True, cs.MASKED_LOOP_TH) for m in u["matrices"])


def test_loop_projection_unmasked(cell):
    """The loop closer's projections (the Sim3 check and SearchAndFuse)
    match unmasked; every other matcher masked."""
    _, u = cell
    counts = u["masks_by_caller"]
    assert u["loops"] >= 1 and counts.get("loop:unmasked", 0) > 0 and "loop:masked" not in counts
    assert all(k.endswith(":masked") for k in counts if not k.startswith("loop:"))
    for caller in ("bootstrap", "tracking", "fuse"):
        assert counts.get(f"{caller}:masked", 0) > 0


def test_captured_launches(cell):
    """The launches phase 8 replays: the last fusion, masked; the last loop
    projections, unmasked."""
    _, u = cell
    cap = u["captured"]
    assert cap["fuse"].get("mask_q") is not None and cap["fuse"].get("mask_t") is not None
    loop = [k for k in cap if k.startswith("loop_")]
    assert loop and all(cap[k].get("mask_q") is None for k in loop)


def test_gates_around_the_reference(cell):
    """chip_smoke.py's gates of the cell (the card's run must pass them)."""
    _, u = cell
    assert cs.masked_loop_gates(u, check_launches=False) == []
