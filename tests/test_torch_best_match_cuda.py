"""The CUDA best-match kernels (K1 over a rig, K2 for one camera) against
their plain PyTorch versions, on the card.

Imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_best_match_cuda.py -q --noconftest

(`--noconftest`: tests/conftest.py configures JAX). Every case skips where
there is no CUDA device. All outputs must be exactly equal."""
import numpy as np
import pytest
import torch

from multicol_slam_tpu_torch.ops.best_match import (
    KERNEL, KERNEL_SINGLE, masked_best_match, masked_best_match_cams, masked_best_match_cams_plain,
    masked_best_match_plain, target_chunk,
)

# (C, Q, T, desc bytes, shared desc_t, masked, ties, share of enabled targets)
CASES = {
    "slice_shared": (3, 400, 4096, 32, True, False, False, 0.8),
    "slice_per_camera_masked": (3, 400, 4096, 32, False, True, False, 0.8),
    "ragged": (3, 37, 1001, 32, True, False, False, 0.8),
    "ragged_masked": (2, 129, 130, 32, False, True, False, 0.8),
    "one_camera": (1, 64, 700, 32, False, False, False, 0.8),
    "ties": (3, 200, 900, 32, True, True, True, 0.8),
    "all_disabled": (3, 16, 256, 32, True, False, False, 0.0),
    "16_bytes": (2, 40, 300, 16, True, True, False, 0.8),
    "64_bytes": (2, 40, 300, 64, False, False, False, 0.8),
    # the split of the targets over blocks: T below one chunk, one past a
    # chunk, 16 chunks + 1; Q one past a query tile
    "T_below_chunk": (3, 400, 50, 32, True, False, False, 0.8),
    "T_chunk_plus_1_masked": (3, 400, 65, 32, False, True, False, 0.8),
    "T_16_chunks_plus_1": (3, 400, 4097, 32, True, False, False, 0.8),
    "Q_tile_plus_1": (3, 65, 4096, 32, False, False, False, 0.8),
    # map-point fusion: the targets' keyframes x 3 cameras as one rig (J = 4
    # and 32), one shared block of L map points
    "fuse_C12_L64": (12, 400, 64, 32, True, False, False, 0.8),
    "fuse_C12_L1024": (12, 400, 1024, 32, True, False, False, 0.8),
    "fuse_C96_L64": (96, 400, 64, 32, True, False, False, 0.8),
    "fuse_C96_L1024": (96, 400, 1024, 32, True, False, False, 0.8),
    # the same with mdBRIEF's masks (the system's masked fusion: the points'
    # masks shared like their descriptors), and with per-camera targets
    "fuse_C24_L400_masked": (24, 400, 400, 32, True, True, False, 0.8),
    "fuse_C24_L400_masked_per_camera": (24, 400, 400, 32, False, True, False, 0.8),
}


def _problem(seed, C, Q, T, B, shared, masked, ties, frac_t):
    rng = np.random.default_rng(seed)
    t_rows = (T,) if shared else (C, T)
    if ties:  # four distinct descriptors on a coarse pixel grid: many equal distances
        pool = rng.integers(0, 256, (4, B), dtype=np.uint8)
        dq, dt = pool[rng.integers(0, 4, (C, Q))], pool[rng.integers(0, 4, t_rows)]
    else:
        dq = rng.integers(0, 256, (C, Q, B), dtype=np.uint8)
        dt = rng.integers(0, 256, t_rows + (B,), dtype=np.uint8)
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_equals_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    p = {k: torch.tensor(v, device="cuda") for k, v in _problem(7, *CASES[case]).items()}
    before = KERNEL.launches
    got = masked_best_match_cams(**p)
    ref = masked_best_match_cams_plain(**p)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    for name, a, b in zip(("best", "second", "idx", "col_best"), got, ref):
        assert torch.equal(a, b), f"{case}: {name}"
    if case == "all_disabled":
        assert (got[2] == -1).all()
    else:
        assert (got[2] >= 0).sum() > 10


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    p = {k: torch.tensor(v, device="cuda") for k, v in _problem(8, *CASES["ragged"]).items()}
    with pytest.raises(ValueError):
        masked_best_match_cams(**{**p, "uv_q": p["uv_q"].double()})
    with pytest.raises(ValueError):
        masked_best_match_cams(**{**p, "uv_t": p["uv_t"].transpose(0, 1).contiguous().transpose(0, 1)})
    with pytest.raises(ValueError):
        masked_best_match_cams(**{**p, "rad_t": p["rad_t"].cpu()})


# K2: (Q, T, desc bytes, ties, share of enabled targets, with rad_q)
K2_CASES = {
    "bootstrap_800": (800, 800, 32, False, 0.8, True),
    "ragged": (37, 1001, 32, False, 0.8, True),
    "no_rad_q": (300, 700, 32, False, 0.8, False),
    "ties": (200, 900, 32, True, 0.8, True),
    "all_disabled": (16, 256, 32, False, 0.0, True),
    "16_bytes": (40, 300, 16, False, 0.8, True),
    "64_bytes": (40, 300, 64, False, 0.8, True),
    "T_below_chunk": (800, 50, 32, False, 0.8, True),
    "T_chunk_plus_1": (800, 65, 32, False, 0.8, True),
    "Q_tile_plus_1": (65, 800, 32, False, 0.8, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_CASES))
def test_cuda_single_camera_kernel_equals_plain_and_k1(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    Q, T, B, ties, frac_t, with_rad_q = K2_CASES[case]
    p = {k: torch.tensor(v[0], device="cuda")    # camera 0 of a one-camera problem
         for k, v in _problem(9, 1, Q, T, B, False, False, ties, frac_t).items()
         if with_rad_q or k != "rad_q"}
    before = (KERNEL.launches, KERNEL_SINGLE.launches)
    got = masked_best_match(**p)
    assert (KERNEL.launches, KERNEL_SINGLE.launches) == (before[0], before[1] + 1)
    ref = masked_best_match_plain(**p)
    k1 = masked_best_match_cams(**{k: v[None] for k, v in p.items()})
    torch.cuda.synchronize()
    for name, a, b, c in zip(("best", "second", "idx"), got, ref, k1):
        assert torch.equal(a, b), f"{case}: {name}"
        assert torch.equal(a, c[0]), f"{case}: {name} vs K1"
    assert ((got[2] >= 0).sum() > 0) == (case != "all_disabled")


def _border_ties(p, chunk):
    """Target b copies target b - 1 at every chunk border b; query i copies
    target b_i - 1, so its best is 0 at b_i - 1 with a tie at b_i."""
    borders = list(range(chunk, p["uv_t"].shape[1], chunk))[: p["uv_q"].shape[1]]
    for i, b in enumerate(borders):
        p["desc_t"][..., b, :] = p["desc_t"][..., b - 1, :]
        for k in ("uv_t", "lvl_t"):
            p[k][:, b] = p[k][:, b - 1]
        p["rad_t"][:, b - 1: b + 1] = 60.0
        p["desc_q"][:, i] = p["desc_t"][..., b - 1, :]
        p["uv_q"][:, i] = p["uv_t"][:, b - 1]
        p["oct_q"][:, i] = p["lvl_t"][:, b - 1]
        p["rad_q"][:, i] = 1e9
    return borders


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 400, 4096), (3, 800, 800), (1, 800, 800)])
def test_cuda_ties_across_chunk_borders(shape):
    """K1 (and K2 at C = 1): a tie that straddles two blocks' chunks goes to
    the lower t, exactly as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    C, Q, T = shape
    p = _problem(11, C, Q, T, 32, False, False, False, 0.8)
    borders = _border_ties(p, target_chunk(C, Q, T))
    p = {k: torch.tensor(v, device="cuda") for k, v in p.items()}
    got = masked_best_match_cams(**p)
    ref = masked_best_match_cams_plain(**p)
    outs = [got]
    if C == 1:
        outs.append(masked_best_match(**{k: v[0] for k, v in p.items()}))
    torch.cuda.synchronize()
    for out in outs:
        for name, a, b in zip(("best", "second", "idx", "col_best"), out, ref):
            assert torch.equal(a.reshape(b.shape), b), f"{shape}: {name}"
    idx = got[2].cpu().numpy()
    for i, b in enumerate(borders):
        assert (idx[:, i] == b - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slice_shared", "slice_per_camera_masked", "ties"])
def test_cuda_kernel_is_deterministic(case):
    """Two calls on the same inputs give bit-identical outputs: the merge of
    the blocks' partials does not depend on the order they finish in."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    p = {k: torch.tensor(v, device="cuda") for k, v in _problem(12, *CASES[case]).items()}
    a = masked_best_match_cams(**p)
    b = masked_best_match_cams(**p)
    torch.cuda.synchronize()
    for name, x, y in zip(("best", "second", "idx", "col_best"), a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f"{case}: {name}"
