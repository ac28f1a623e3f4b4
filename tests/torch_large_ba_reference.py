"""The large-map BA of chip_smoke.py phase 18 on the CPU, in the JAX package
and in the port: `make_large_ba_problem(64, 50_000, 500_000, seed=0)`
sorted by point id (bench_ba.py:63-64), 10 LM iterations of 20 PCG steps,
gain_eps=0 (every iteration runs), the rig fixed (the reference's
solve_mc=False, solve_intr=False; the port's default FreeMask).

    python tests/torch_large_ba_reference.py [--port-only | --jax-only]

Prints each package's initial and final robust cost, the rows whose
`valid` differ between the two problems, and one JSON line. Phase 18 gates
the card's final cost within 1 % of the JAX package's (it holds the number
as a constant: the card's machine has no JAX). JAX is imported inside
`jax_reference` only; `port_reference` is the port's side. Takes a few
minutes and ~4 GB on the CPU.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBLEM = dict(n_kfs=64, n_points=50_000, n_obs=500_000, seed=0)
N_LM, N_CG = 10, 20


def jax_reference():
    """(initial cost, final cost, valid [O] in the sorted row order) of the
    JAX package on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import functools

    import jax.numpy as jnp

    from multicol_slam_tpu.optim.lm import LMConfig, _lm_cost, lm_solve
    from multicol_slam_tpu.parallel.distributed import make_large_ba_problem

    noisy, _, obs, free = make_large_ba_problem(**PROBLEM)
    order = np.argsort(np.asarray(obs.pt), kind="stable")
    obs = type(obs)(*(jnp.asarray(np.asarray(c)[order]) for c in obs))
    cfg = LMConfig(max_iters=N_LM, cg_iters=N_CG, gain_eps=0.0, solve_mc=False, solve_intr=False)
    cost0 = float(jax.jit(functools.partial(_lm_cost, config=cfg))(noisy, obs))
    _, cost = jax.jit(functools.partial(lm_solve, config=cfg))(noisy, obs, free)
    return cost0, float(cost), np.asarray(obs.valid)


def port_reference():
    """The same for the port on the CPU (torch and the port only)."""
    import torch

    from multicol_slam_tpu_torch.optim.lm import LMConfig, _lm_cost, lm_solve
    from multicol_slam_tpu_torch.parallel.distributed import make_large_ba_problem

    noisy, _, obs, free = make_large_ba_problem(**PROBLEM, device="cpu")
    order = torch.argsort(obs.pt, stable=True)
    obs = type(obs)(*(c[order] for c in obs))
    cfg = LMConfig(max_iters=N_LM, cg_iters=N_CG, gain_eps=0.0)
    cost0 = float(_lm_cost(noisy, obs, cfg))
    _, cost = lm_solve(noisy, obs, free, cfg)
    return cost0, float(cost), obs.valid.numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--jax-only", action="store_true")
    args = ap.parse_args(argv)
    out = {}
    valid = {}
    for name, fn in (("jax", jax_reference), ("port", port_reference)):
        if (name == "jax" and args.port_only) or (name == "port" and args.jax_only):
            continue
        t0 = time.perf_counter()
        cost0, cost, valid[name] = fn()
        out[name] = dict(cost0=cost0, cost=cost, s=time.perf_counter() - t0)
        print(f"{name}: initial cost {cost0!r}, final cost {cost!r} after {N_LM} LM iterations "
              f"({out[name]['s']:.1f} s on the CPU)", flush=True)
    if len(valid) == 2:
        flips = np.nonzero(valid["jax"] != valid["port"])[0]
        out["valid_flips"] = flips.tolist()
        out["final_cost_rel"] = out["port"]["cost"] / out["jax"]["cost"] - 1.0
        print(f"valid differs on {len(flips)} of {len(valid['jax'])} rows; the port's final cost / the JAX "
              f"package's - 1 = {out['final_cost_rel']:.3e}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
