"""Port parity for K2: the plain single-camera best-match
(`masked_best_match_plain`, the CUDA kernel's CPU version) against the
reference TPU kernel `masked_best_match_pallas` run in interpret mode, and
against the reference's jnp oracle `masked_best_match_reference`. best,
second and idx must be exactly equal: distances are exact integers and the
tie rules are part of the contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.ops.pallas_match import (
    masked_best_match_pallas, masked_best_match_reference,
)
from multicol_slam_tpu_torch.ops.best_match import (
    KERNEL, KERNEL_SINGLE, masked_best_match, masked_best_match_cams_plain,
    masked_best_match_plain,
)

NAMES = ("best", "second", "idx")
LEVEL_TOL = 2.0


def _problem(seed, Q, T, B=32, frac_t=0.8, ties=False, with_rad_q=True):
    """The inputs of tests/test_pallas_match.py's `_problem`, plus ties."""
    rng = np.random.default_rng(seed)
    if ties:  # four distinct descriptors on a coarse pixel grid: many equal distances
        pool = rng.integers(0, 256, (4, B), dtype=np.uint8)
        dq, dt = pool[rng.integers(0, 4, Q)], pool[rng.integers(0, 4, T)]
    else:
        dq = rng.integers(0, 256, (Q, B), dtype=np.uint8)
        dt = rng.integers(0, 256, (T, B), dtype=np.uint8)
    uvq = rng.uniform(0, 500, (Q, 2)).astype(np.float32)
    uvt = rng.uniform(0, 500, (T, 2)).astype(np.float32)
    if ties:
        uvq, uvt = np.round(uvq / 25) * 25, np.round(uvt / 25) * 25
    p = dict(
        desc_q=dq, uv_q=uvq, oct_q=rng.integers(0, 8, Q).astype(np.float32),
        desc_t=dt, uv_t=uvt,
        rad_t=np.where(rng.uniform(size=T) < frac_t, rng.uniform(20, 300, T), -1.0).astype(np.float32),
        lvl_t=rng.integers(0, 8, T).astype(np.float32),
    )
    if with_rad_q:
        p["rad_q"] = np.where(rng.uniform(size=Q) < 0.9, 1e9, -1.0).astype(np.float32)
    return p


CASES = {
    "Q37_T700": dict(seed=37700, Q=37, T=700),
    "Q128_T512": dict(seed=128512, Q=128, T=512),
    "Q5_T1030": dict(seed=5030, Q=5, T=1030),
    "no_rad_q": dict(seed=11, Q=64, T=600, with_rad_q=False),
    "ties": dict(seed=12, Q=96, T=700, ties=True),
    "all_disabled": dict(seed=13, Q=16, T=256, frac_t=0.0),
}


def _plain(p):
    return [o.numpy() for o in masked_best_match_plain(**{k: torch.tensor(v) for k, v in p.items()},
                                                       level_tol=LEVEL_TOL)]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_tpu_kernel_and_oracle(case):
    p = _problem(**CASES[case])
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = _plain(p)
    kern = masked_best_match_pallas(**jp, level_tol=LEVEL_TOL, interpret=True)
    oracle = masked_best_match_reference(**jp, level_tol=LEVEL_TOL)
    for name, a, b, c in zip(NAMES, got, kern, oracle):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{case}: {name} vs kernel")
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=f"{case}: {name} vs oracle")
    if case == "all_disabled":
        assert (got[2] == -1).all() and (got[0] == 1e9).all() and (got[1] == 1e9).all()
    else:
        assert (got[2] >= 0).sum() >= min(4, p["desc_q"].shape[0] - 1)
    if case == "ties":  # the case really has a tie at the minimum
        assert ((got[0] == got[1]) & (got[2] >= 0)).sum() > 10


def test_plain_equals_k1_plain_at_one_camera():
    p = {k: torch.tensor(v) for k, v in _problem(**CASES["Q128_T512"]).items()}
    one = {k: v[None] for k, v in p.items() if k != "desc_t"}
    ref = masked_best_match_cams_plain(**one, desc_t=p["desc_t"], level_tol=LEVEL_TOL)
    for a, b in zip(masked_best_match_plain(**p, level_tol=LEVEL_TOL), ref):
        assert torch.equal(a, b[0])


def test_wrapper_takes_plain_version_on_cpu():
    p = {k: torch.tensor(v) for k, v in _problem(**CASES["ties"]).items()}
    before = (KERNEL.launches, KERNEL_SINGLE.launches)
    got = masked_best_match(**p)
    assert (KERNEL.launches, KERNEL_SINGLE.launches) == before
    for a, b in zip(got, masked_best_match_plain(**p)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_equals_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")
    p = {k: torch.tensor(v, device="cuda") for k, v in _problem(**CASES[case]).items()}
    before = KERNEL_SINGLE.launches
    got = masked_best_match(**p, level_tol=LEVEL_TOL)
    ref = masked_best_match_plain(**p, level_tol=LEVEL_TOL)
    torch.cuda.synchronize()
    assert KERNEL_SINGLE.launches == before + 1
    for name, a, b in zip(NAMES, got, ref):
        assert torch.equal(a, b), f"{case}: {name}"
