"""The port's distributed BA (`multicol_slam_tpu_torch/parallel/`) against the
JAX package's (`multicol_slam_tpu/parallel/`): the JAX side on
tests/conftest.py's 8-device CPU mesh in this process, the port's in gloo
ranks spawned by tests/torch_multihost_worker.py (one intra-op thread a
rank), on the problems of tests/test_torch_lm_ba.py.

Tolerances:
- make_large_ba_problem: indices exact; `valid` equal on >= 99.9 % of the
  rows (both packages project in float32, so a row on the image border may
  flip; measured: none at (8, 400, 4000, seed 3), nor at the full
  64 / 50k / 500k, tests/torch_large_ba_reference.py); uv within 1e-3 px
  (measured 1.5e-5); the noisy parameters within 1e-6 (measured 0).
- The reducer, in one process, over 3 shards summed by hand: gradient,
  blocks, Hessian-vector product and cost within 1e-5 of the largest entry
  (the sums over shards are added in another order; measured 5.1e-7).
- The solves: within 5e-3 of the JAX package's distributed solve and of
  its single-device `bundle_adjust` (the tolerance of
  tests/test_parallel.py); measured <= 1.2e-6 on poses and <= 9.1e-6 on
  points at world sizes 2 and 4, both layouts and the ragged rows.
- World size 1 and the ranks: bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multicol_slam_tpu.optim.ba import bundle_adjust as jbundle_adjust
from multicol_slam_tpu.optim.problem import FreeMask as JFree
from multicol_slam_tpu.parallel import ba as jpba
from multicol_slam_tpu.parallel.distributed import make_large_ba_problem as jmake_large
from multicol_slam_tpu_torch.optim import lm
from multicol_slam_tpu_torch.optim.problem import (
    BAParams, FreeMask, Observations, huber_weights, residuals_and_jacobians, residuals_only, robust_cost,
)
from multicol_slam_tpu_torch.parallel.ba import pad_observations
from multicol_slam_tpu_torch.parallel.distributed import make_large_ba_problem
from tests.test_torch_lm_ba import _close, jax_side, make_problem, perturbed, torch_side
from tests.torch_multihost_worker import OBS, PARAMS, run_ranks

WORLDS = (2, 4)
TOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_large_ba_problem_matches_jax():
    jn, jg, jo, jf = jmake_large(n_kfs=8, n_points=400, n_obs=4000, noise_px=0.2, seed=3)
    tn, tg, to, tf = make_large_ba_problem(n_kfs=8, n_points=400, n_obs=4000, noise_px=0.2, seed=3, device="cpu")
    for name in ("kf", "pt", "cam", "inv_sigma2"):
        np.testing.assert_array_equal(getattr(to, name).numpy(), np.asarray(getattr(jo, name)), err_msg=name)
    flips = np.nonzero(to.valid.numpy() != np.asarray(jo.valid))[0]
    assert len(flips) <= 1e-3 * to.valid.shape[0], f"valid differs on rows {flips.tolist()}"
    assert np.asarray(jo.valid).mean() > 0.5
    np.testing.assert_allclose(to.uv.numpy(), np.asarray(jo.uv), rtol=0, atol=1e-3)
    for a, b in zip(tn + tg, jn + jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pad_observations():
    """Equal to the reference's padding; the padding rows weigh nothing in
    the IRLS weights and the robust cost."""
    params, obs = make_problem(K=3, P=31)[:2]
    obs = {k: v[:97] for k, v in obs.items()}
    _, jo = jax_side(params, obs)
    tp, to = torch_side(params, obs)
    tp = tp._replace(points=tp.points + 0.05)
    r, z = residuals_only(tp, to)
    cost = robust_cost(r, z, to, 2.4477)
    for m in (1, 4, 8, 97):
        got, want = pad_observations(to, m), jpba.pad_observations(jo, m)
        assert got.kf.shape[0] % m == 0
        for name, a, b in zip(OBS, got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} {m}")
            assert a.dtype == getattr(to, name).dtype
        r, z = residuals_only(tp, got)
        w, chi2 = huber_weights(r, z, got, 2.4477)
        assert not w[97:].any() and not chi2[97:].any()
        assert abs(float(robust_cost(r, z, got, 2.4477)) - float(cost)) <= 1e-6 * float(cost)
    assert pad_observations(to, 97) is to


# --- the reducer hook in one process: three shards summed by hand -----------

def _row_shards(tp, to, tfree, v, n):
    to = pad_observations(to, n)
    per = to.kf.shape[0] // n
    return [(tp, Observations(*(x[s * per:(s + 1) * per] for x in to)), tfree, v) for s in range(n)]


def _point_shards(tp, to, tfree, v, n):
    """Each shard: a block of points and the rows that observe them, obs.pt
    in local indices (the point-sharded layout's host prep, rows unpadded)."""
    P = tp.points.shape[0]
    per = -(-P // n)
    pad = n * per - P

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    pts, fpts, vpts = padded(tp.points), padded(tfree.points), padded(v.points)
    out = []
    for s in range(n):
        rows = (to.pt.long() // per) == s
        o = Observations(*(x[rows] for x in to))
        o = o._replace(pt=o.pt - s * per)
        blk = slice(s * per, (s + 1) * per)
        out.append((tp._replace(points=pts[blk]), o, tfree._replace(points=fpts[blk]), v._replace(points=vpts[blk])))
    return out


def _hand_summed(call, n):
    """call(s, reducer) for every shard, twice: first capturing each shard's
    partial buffer, then with the buffers' sum written in place. Returns the
    second pass's results."""
    partial = []
    for s in range(n):
        call(s, lambda t: partial.append(t.clone()))
    assert len(partial) == n
    total = partial[0] + partial[1] + partial[2]
    return [call(s, lambda t: t.copy_(total)) for s in range(n)]


@pytest.mark.parametrize("layout", ["rows", "points"])
def test_reducer_sums_the_shards(layout):
    """Gradient, blocks, Hessian-vector product, cost and (points sharded)
    inner product of 3 shards, reduced by a hand-summed reducer, equal the
    unsharded ones; with points sharded each shard's point pieces are its
    block of the unsharded ones."""
    params, obs, (_, tfree), _ = perturbed("full")
    tp, to = torch_side(params, obs)
    cfg = lm.LMConfig(points_sharded=layout == "points")
    ps = cfg.points_sharded
    rng = np.random.default_rng(3)
    v = BAParams(*(torch.tensor(rng.normal(size=x.shape).astype(np.float32)) for x in tp))
    lam = torch.tensor(1e-3)

    def pieces(p, o):
        r, z, Jp, Jx, Jm, Ji = residuals_and_jacobians(p, o, with_mc=False, with_intr=False)
        w, _ = huber_weights(r, z, o, cfg.huber_delta)
        return lm.make_segments(p, o), r, Jp, Jx, w

    seg, r, Jp, Jx, w = pieces(tp, to)
    g, blocks = lm._build_grad_and_blocks(tp, seg, Jp, Jx, None, None, w, r)
    h = lm._hvp(to, seg, Jp, Jx, None, None, w, lam, blocks, tfree, v)
    cost = lm._lm_cost(tp, to, cfg)
    dot = lm._dot(v, h)

    shards = (_point_shards if ps else _row_shards)(tp, to, tfree, v, 3)
    sp = [pieces(p, o) for p, o, _, _ in shards]
    gb = _hand_summed(lambda s, red: lm._build_grad_and_blocks(shards[s][0], sp[s][0], sp[s][2], sp[s][3], None,
                                                               None, sp[s][4], sp[s][1], red, ps), 3)
    hs = _hand_summed(lambda s, red: lm._hvp(shards[s][1], sp[s][0], sp[s][2], sp[s][3], None, None, sp[s][4], lam,
                                             gb[s][1], shards[s][2], shards[s][3], red, ps), 3)
    cs = _hand_summed(lambda s, red: lm._lm_cost(shards[s][0], shards[s][1], cfg, red), 3)
    per = shards[0][0].points.shape[0]
    for s in range(3):
        blk = slice(s * per, (s + 1) * per) if ps else slice(None)
        (gs, bs), hv = gb[s], hs[s]
        for name, a, b in zip(("pose", "point", "mc", "intr"), g, gs):
            a = a[blk][:b.shape[0]] if name == "point" else a
            _close(a.numpy(), b[:a.shape[0]].numpy(), 1e-5)
        for name, a, b in zip(("U", "V", "Um", "Ui"), blocks, bs):
            a = a[blk] if name == "V" else a
            _close(a.numpy(), b[:a.shape[0]].numpy(), 1e-5)
        for name, a, b in zip(("pose", "point", "mc", "intr"), h, hv):
            a = a[blk] if name == "point" else a
            _close(a.numpy(), b[:a.shape[0]].numpy(), 1e-5)
        _close(cost.numpy(), cs[s].numpy(), 1e-5)
    if ps:
        ds = _hand_summed(lambda s, red: lm._dot(shards[s][3], hs[s], red, True), 3)
        for d in ds:
            _close(dot.numpy(), d.numpy(), 1e-5)


def test_distributed_solve_refuses_an_interrupt():
    params, obs, (_, tfree), _ = perturbed("full")
    tp, to = torch_side(params, obs)
    for kw in (dict(interrupt=lambda: False), dict(pre_step=lambda: None)):
        with pytest.raises(ValueError, match="same branch"):
            lm.lm_solve_interruptible(tp, to, tfree, lm.LMConfig(), reducer=lambda t: None, **kw)


# --- the solves, in gloo ranks ----------------------------------------------

def _cases():
    """(name, numpy params, numpy obs, free poses, free points, layouts):
    tests/test_parallel.py's three problems at the port's test sizes."""
    full = perturbed("full")
    p61, o61, rng = make_problem(K=5, P=61)
    p61["poses"] = p61["poses"] + np.concatenate([np.zeros((1, 6)), rng.normal(0, 0.02, (4, 6))]).astype(np.float32)
    p61["points"] = p61["points"] + rng.normal(0, 0.05, (61, 3)).astype(np.float32)
    rag, orag, _ = make_problem(K=4, P=50)
    orag = {k: v[:397] for k, v in orag.items()}                    # a prime row count
    rag["points"] = rag["points"] + np.float32(0.03)
    return [("full", full[0], full[1], np.array([False] + [True] * 4), np.ones(60, bool)),
            ("p61", p61, o61, np.array([False] + [True] * 4), np.ones(61, bool)),
            ("ragged", rag, orag, np.array([False] + [True] * 3), np.ones(50, bool))]


CASES = {name: i for i, (name, *_) in enumerate(_cases())}


# the layouts each world size runs, by case
LAYOUTS = {1: {"full": "rows,points"}, 2: {"full": "rows", "p61": "points"},
           4: {"full": "rows", "p61": "points", "ragged": "rows,points"}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases of LAYOUTS at world sizes 1, 2 and 4, the three worlds side
    by side: {world: the ranks' outputs}."""
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("parallel")
    cases = _cases()
    for world, layouts in LAYOUTS.items():
        arrays = {"n": len(cases)}
        for i, (name, p, o, fp, fx) in enumerate(cases):
            arrays.update({f"{i}/{k}": p[k] for k in PARAMS})
            arrays.update({f"{i}/{k}": o[k] for k in OBS})
            arrays.update({f"{i}/free_poses": fp, f"{i}/free_points": fx, f"{i}/max_iters": 15,
                           f"{i}/cg_iters": 20, f"{i}/layouts": layouts.get(name, "")})
        np.savez(d / f"cases{world}.npz", **arrays)
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {w: pool.submit(run_ranks, w, "cases", str(d / f"w{w}"), cases=str(d / f"cases{w}.npz"),
                                  timeout=240) for w in LAYOUTS}
        return {w: f.result() for w, f in futures.items()}


def _jax_case(name):
    _, p, o, fp, fx = _cases()[CASES[name]]
    jp, jo = jax_side(p, o)
    return jp, jo, JFree(jnp.asarray(fp), jnp.asarray(fx))


def _assert_near(out, ref, what):
    for key in ("poses", "points"):
        err = np.abs(out[key] - np.asarray(getattr(ref, key))).max()
        assert err <= TOL, f"{what}: {key} differ by {err}"


def _result(rank_out, name, layout):
    i = CASES[name]
    return {k: rank_out[f"{i}/{layout}/{k}"] for k in ("poses", "points", "cost")}


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_matches_jax(runs, world):
    """Rows sharded over `world` ranks: the JAX package's
    distributed_bundle_adjust on a `world`-device mesh and its single-device
    bundle_adjust (tests/test_parallel.py's problem and tolerance)."""
    jp, jo, jf = _jax_case("full")
    ref_d, _ = jpba.distributed_bundle_adjust(jp, jo, jf, jpba.make_mesh(world))
    ref_s, _ = jbundle_adjust(jp, jo, jf, max_iters=15, cg_iters=20)
    got = _result(runs[world][0], "full", "rows")
    _assert_near(got, ref_d, "against the JAX package's distributed solve")
    _assert_near(got, ref_s, "against the JAX package's single-device solve")
    gt = make_problem(K=5, P=60)[0]
    assert np.abs(got["poses"] - gt["poses"]).max() < 1e-2


@pytest.mark.parametrize("world", WORLDS)
def test_point_sharded_matches_jax(runs, world):
    """Points and their rows co-sharded, P = 61 (not a multiple of the world
    size: padded points), against the JAX package's point-sharded solve and
    its single-device one."""
    jp, jo, jf = _jax_case("p61")
    ref_p, cost_p = jpba.point_sharded_bundle_adjust(jp, jo, jf, jpba.make_mesh(world))
    ref_s, cost_s = jbundle_adjust(jp, jo, jf, max_iters=15, cg_iters=20)
    got = _result(runs[world][0], "p61", "points")
    assert got["points"].shape == (61, 3)
    _assert_near(got, ref_p, "against the JAX package's point-sharded solve")
    _assert_near(got, ref_s, "against the JAX package's single-device solve")
    assert got["cost"] <= float(cost_s) * 1.05 + 1e-6


@pytest.mark.parametrize("layout", ["rows", "points"])
def test_ragged_row_count(runs, layout):
    """397 rows (a prime) over 4 ranks: the padding rows weigh nothing. Both
    layouts reach the JAX package's distributed solve of the same rows and
    the ground truth's points (tests/test_parallel.py's gate, 2e-2)."""
    jp, jo, jf = _jax_case("ragged")
    ref, _ = jpba.distributed_bundle_adjust(jp, jo, jf, jpba.make_mesh(4))
    got = _result(runs[4][0], "ragged", layout)
    assert np.isfinite(got["cost"])
    _assert_near(got, ref, "against the JAX package's distributed solve")
    gt = make_problem(K=4, P=50)[0]
    assert np.abs(got["points"] - gt["points"]).max() < 2e-2


@pytest.mark.parametrize("layout", ["rows", "points"])
def test_world_of_one_is_lm_solve(runs, layout):
    """One rank: the row layout is lm_solve to the bit (no padding, the
    reduced buffers unchanged); the point layout too, its rows reordered
    only by a stable sort on one owner."""
    for name in LAYOUTS[1]:
        _, p, o, fp, fx = _cases()[CASES[name]]
        tp, to = torch_side(p, o)
        ref, cost = lm.lm_solve(tp, to, FreeMask(torch.tensor(fp), torch.tensor(fx)), lm.LMConfig(15, 20))
        got = _result(runs[1][0], name, layout)
        np.testing.assert_array_equal(got["poses"], ref.poses.numpy(), err_msg=name)
        np.testing.assert_array_equal(got["points"], ref.points.numpy(), err_msg=name)
        assert got["cost"] == float(cost), name


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_params(runs, world):
    outs = runs[world]
    for r in range(1, world):
        for key, a in outs[0].items():
            if key.endswith(("poses", "points", "cost")):
                np.testing.assert_array_equal(outs[r][key], a, err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_asserts(world, tmp_path):
    """__graft_entry__.dryrun_multichip's contract on its tiny problem (4
    poses, 32 points, 2 cameras, 256 rows, 2 LM / 4 CG iterations): both
    layouts lower the cost below half its start and stay within 5e-3 of the
    single-device lm_solve; every rank returns the same parameters. The
    worker's job runs the package's graft_entry.dryrun_multichip."""
    outs = run_ranks(world, "dryrun", str(tmp_path / "dry"), timeout=120)
    o = outs[0]
    for layout in ("rows", "points"):
        assert o[f"0/{layout}/cost"] < 0.5 * o["0/cost0"], layout
        for key in ("poses", "points"):
            err = np.abs(o[f"0/{layout}/{key}"] - o[f"0/single/{key}"]).max()
            assert err <= TOL, (layout, key, err)
            for r in range(1, world):
                np.testing.assert_array_equal(outs[r][f"0/{layout}/{key}"], o[f"0/{layout}/{key}"])
