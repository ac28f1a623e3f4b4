"""The port's BA bench (multicol_slam_tpu_torch/bench_ba.py) against the
repository's bench_ba.py on the CPU, on a small make_large_ba_problem (8
keyframes, 2000 points, 20000 rows) with bench_ba.py:63-68's sort and
config (10 LM iterations of 20 PCG steps, gain_eps 0, the rig fixed):

- the single solve's final cost within 1e-4 (relative) of the JAX
  package's `lm_solve`;
- two gloo ranks (the spawn helper `bench_over_ranks`, `--cpu8`'s path at 2
  ranks) add the three n-device keys, the distributed cost within 1e-5 of
  the single solve's;
- the key sets equal bench_ba.py:87-106's (read from its source).
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.optim.lm import LMConfig as JLMConfig
from multicol_slam_tpu.optim.lm import lm_solve as jlm_solve
from multicol_slam_tpu.parallel.distributed import make_large_ba_problem as jmake_large_ba_problem
from multicol_slam_tpu_torch import bench_ba
from multicol_slam_tpu_torch.parallel.distributed import make_large_ba_problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_kfs=8, n_points=2000, n_obs=20000)
COST_REL, SHARDED_REL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single():
    return bench_ba.bench(*bench_ba.sorted_problem(**SMALL, device="cpu"))


@pytest.fixture(scope="module")
def two_ranks():
    return bench_ba.bench_over_ranks(2, SMALL)


def _reference_keys():
    """The keys of bench_ba.py's result: its dict literal and its update."""
    with open(os.path.join(ROOT, "bench_ba.py")) as f:
        tree = ast.parse(f.read())
    single, update = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            single |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "update" \
                and getattr(node.func.value, "id", None) == "result":
            update |= {k.value for k in node.args[0].keys}
    return single, update


def test_sorted_solve_matches_jax(single):
    noisy, _, obs, free = jmake_large_ba_problem(**SMALL)
    order = np.argsort(np.asarray(obs.pt), kind="stable")                 # bench_ba.py:63-64
    obs = type(obs)(*(jnp.asarray(np.asarray(c)[order]) for c in obs))
    cfg = JLMConfig(max_iters=10, cg_iters=20, gain_eps=0.0, solve_mc=False, solve_intr=False)
    _, cost = jlm_solve(noisy, obs, free, cfg)
    assert single["final_cost"] == pytest.approx(float(cost), rel=COST_REL)
    assert single["n_devices_visible"] == 1 and single["value"] > 0
    assert single["vs_baseline"] == pytest.approx(single["value"] / 75.0)


def test_sorted_problem_is_sorted_and_stable():
    _, obs, _ = bench_ba.sorted_problem(**SMALL, device="cpu")
    pt = obs.pt.numpy()
    assert (np.diff(pt) >= 0).all()
    _, _, raw, _ = make_large_ba_problem(**SMALL, device="cpu")
    order = np.argsort(raw.pt.numpy(), kind="stable")
    np.testing.assert_array_equal(obs.kf.numpy(), raw.kf.numpy()[order])


def test_two_ranks_add_the_n_device_keys(single, two_ranks):
    assert two_ranks["n_devices_visible"] == 2
    assert two_ranks["final_cost"] == single["final_cost"]
    assert two_ranks["final_cost_n_devices"] == pytest.approx(single["final_cost"], rel=SHARDED_REL)
    assert two_ranks["value_n_devices"] > 0
    assert two_ranks["scaling_efficiency"] == pytest.approx(two_ranks["value_n_devices"] / (2 * two_ranks["value"]))


def test_key_sets_are_the_references(single, two_ranks):
    keys, n_device_keys = _reference_keys()
    assert set(single) == keys
    assert set(two_ranks) == keys | n_device_keys
