"""The best-match kernel's split of the targets over blocks and its exact
merge, in PyTorch: `masked_best_match_cams_split_plain` (the plain version
computed per chunk of targets and merged in increasing chunk order) must
equal the dense plain version exactly for every chunk, and, at chunk =
tile_t, the reference TPU kernel `masked_best_match_pallas_cams` run in
interpret mode, whose grid merges its target tiles the same way."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops.pallas_match import masked_best_match_pallas_cams
from multicol_slam_tpu_torch.ops.best_match import (
    MIN_BLOCKS, QUERY_TILE, TARGET_TILE, masked_best_match_cams_plain,
    masked_best_match_cams_split_plain, target_chunk,
)

T = 300
NAMES = ("best", "second", "idx", "col_best")


def _problem(seed, C=3, Q=40, T=T, shared=False, masked=False, ties=False, frac_t=0.8, B=32):
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


CASES = {
    "plain": dict(seed=20),
    "masked": dict(seed=21, masked=True),
    "shared_desc_t": dict(seed=22, shared=True),
    "shared_masked": dict(seed=23, shared=True, masked=True),
    "ties": dict(seed=24, shared=True, ties=True),
    "all_disabled": dict(seed=25, frac_t=0.0),
}


def _torch(p):
    return {k: torch.tensor(v) for k, v in p.items()}


@pytest.mark.parametrize("chunk", [1, 7, 128, 256, T])
@pytest.mark.parametrize("case", list(CASES))
def test_split_plain_equals_plain(case, chunk):
    p = _torch(_problem(**CASES[case]))
    got = masked_best_match_cams_split_plain(**p, chunk=chunk)
    ref = masked_best_match_cams_plain(**p)
    for name, a, b in zip(NAMES, got, ref):
        assert torch.equal(a, b), f"{case}, chunk {chunk}: {name}"
    assert ((got[2] >= 0).sum() > 0) == (case != "all_disabled")


@pytest.mark.parametrize("chunk", [7, 64, 128])
def test_split_plain_ties_across_chunk_borders(chunk):
    p = _problem(26)
    borders = _border_ties(p, chunk)
    p = _torch(p)
    got = masked_best_match_cams_split_plain(**p, chunk=chunk)
    ref = masked_best_match_cams_plain(**p)
    for name, a, b in zip(NAMES, got, ref):
        assert torch.equal(a, b), f"chunk {chunk}: {name}"
    best, second, idx = got[0].numpy(), got[1].numpy(), got[2].numpy()
    for i, b in enumerate(borders):  # the lower chunk keeps the tie
        assert (idx[:, i] == b - 1).all() and (best[:, i] == 0).all() and (second[:, i] == 0).all()


@pytest.mark.parametrize("tile_t", [128, 256])
@pytest.mark.parametrize("case", ["plain", "masked", "ties"])
def test_split_plain_equals_tpu_kernel_tiles(case, tile_t):
    p = _problem(**CASES[case])
    ref = masked_best_match_pallas_cams(**{k: jnp.asarray(v) for k, v in p.items()},
                                        level_tol=1.0, tile_t=tile_t, interpret=True)
    got = masked_best_match_cams_split_plain(**_torch(p), chunk=tile_t)
    for name, a, b in zip(NAMES, got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{case}, tile_t {tile_t}: {name}")


@pytest.mark.parametrize("shape, chunk", [((3, 400, 4096), 128), ((3, 800, 800), 64),
                                          ((1, 800, 800), 64), ((3, 400, 50), 64), ((3, 400, 16384), 256)])
def test_target_chunk_fills_the_card(shape, chunk):
    """The main path's shapes: tracking (C=3, Q=400, T=4096), the bootstrap
    (3 x 800 x 800) and K2 (800 x 800) get at least MIN_BLOCKS blocks."""
    C, Q, T_ = shape
    assert target_chunk(C, Q, T_) == chunk
    assert chunk % TARGET_TILE == 0 and chunk <= 256
    blocks = C * -(-Q // QUERY_TILE) * -(-T_ // chunk)
    assert blocks >= MIN_BLOCKS or chunk == TARGET_TILE
