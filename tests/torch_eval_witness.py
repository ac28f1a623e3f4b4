"""Witness of one sync `eval --mdbrief` run (the eval recipe of
multicol_slam_tpu_torch/eval.py: the `line` world, 600 landmarks, 3 rendered
cameras, 200 features x 2 levels, mdBRIEF with learned masks, 25 frames,
`--sync-mapping`), frame by frame, to find where two runs part:

    python tests/torch_eval_witness.py run --device cuda --seed 8 --out card.npz
    python tests/torch_eval_witness.py run --device cpu --seed 8 --out cpu.npz
    python tests/torch_eval_witness.py run --package jax --seed 8 --out jax.npz
    python tests/torch_eval_witness.py run --device cpu --seed 8 --features card.npz --out cpu_on_card.npz
    python tests/torch_eval_witness.py compare card.npz cpu.npz

`run` drives the port's eval entry (or, with `--package jax`, the JAX
package's, on the CPU) and writes per frame: the features the system
tracked (every FrameFeatures field), the state, pose, matches and
inliers, and per bootstrap attempt the window-match count, the winning
camera and the chosen (R, t) of every camera's essential RANSAC.
`compare` names the first frame and the first stage at which two
witnesses differ: extraction (keypoints, octaves, descriptor or mask
bits), the bootstrap (matches, the RANSAC's (R, t), the accepted pair),
or tracking (state, matches, inliers, pose). `--features NPZ` (the port
only) tracks another witness's features, frame by frame, in place of the
frames' own extraction: the card's features through the CPU's tracking, or
the CPU's through the card's, tell the extractor's part from the rest. A
port run takes ~30-100 s on the CPU; the JAX run ~2 min (its compiles).
"""
import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("uv", "response", "octave", "angle", "rays", "desc", "dmask", "valid")
POSE_TOL = 1e-4     # a pose "the same" across the two runs (float32)


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def record_run(package: str, device: str, seed: int, n_frames: int, out: str, replay=None):
    sys.path.insert(0, ROOT)
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import eval as entry
        from multicol_slam_tpu.slam import initializer, system
        run = lambda d: entry._synthetic(n_frames, d, False, seed, True)  # noqa: E731
    else:
        import torch
        from multicol_slam_tpu_torch import convert
        from multicol_slam_tpu_torch import eval as entry
        from multicol_slam_tpu_torch.slam import initializer, system
        run = lambda d: entry._synthetic(n_frames, d, False, seed, torch.device(device), True)  # noqa: E731
    frames, boots, ransac = [], [], []
    cls = system.MultiColSLAM
    orig = dict(begin=cls.track_begin, finish=cls.track_finish, boot=system.bootstrap,
                ransac=initializer.ransac_essential)

    def begin(slam, images=None, feats=None, timestamp=0.0):
        if replay is not None:
            t = len(frames)
            feats = convert.frame_features_from_numpy(**{k: replay[f"f{t}_{k}"] for k in FIELDS}, device=slam.device)
        frames.append({k: _host(getattr(feats, k)) for k in FIELDS})
        return orig["begin"](slam, images=images, feats=feats, timestamp=timestamp)

    def finish(slam, h):
        m = orig["finish"](slam, h)
        frames[-1].update(state=int(m.state), pose=np.asarray(m.pose, np.float32), n_matches=int(m.n_matches),
                          n_inliers=int(m.n_inliers))
        return m

    def boot(*a, **kw):
        ransac.clear()
        res, n = orig["boot"](*a, **kw)
        boots.append(dict(frame=len(frames) - 1, n_matches=int(n), ok=res is not None,
                          leading_cam=-1 if res is None else int(res.leading_cam),
                          Mt2=np.full((4, 4), np.nan) if res is None else np.asarray(res.Mt2, np.float64),
                          R=np.stack([r[0] for r in ransac]) if ransac else np.zeros((0, 3, 3)),
                          t=np.stack([r[1] for r in ransac]) if ransac else np.zeros((0, 3)),
                          inliers=np.asarray([r[2] for r in ransac], np.int64)))
        return res, n

    def essential(*a, **kw):
        r = orig["ransac"](*a, **kw)
        ransac.append((_host(r.R), _host(r.t), int(r.n_inliers)))
        return r
    cls.track_begin, cls.track_finish = begin, finish
    system.bootstrap, initializer.ransac_essential = boot, essential
    try:
        result = run(tempfile.mkdtemp(prefix="eval_witness_"))
    finally:
        cls.track_begin, cls.track_finish = orig["begin"], orig["finish"]
        system.bootstrap, initializer.ransac_essential = orig["boot"], orig["ransac"]
    arrays = {"result": np.asarray(repr(result))}
    for t, f in enumerate(frames):
        arrays.update({f"f{t}_{k}": v for k, v in f.items()})
    for i, b in enumerate(boots):
        arrays.update({f"b{i}_{k}": v for k, v in b.items()})
    np.savez(out, n_frames=len(frames), n_boots=len(boots), **arrays)
    print(result)
    print(f"{len(frames)} frames, {len(boots)} bootstrap attempts -> {out}")


def _bits_differ(a, b):
    return int((np.unpackbits(a.astype(np.uint8)) != np.unpackbits(b.astype(np.uint8))).sum())


def compare(a_path: str, b_path: str) -> str:
    """The first frame and stage at which the two witnesses part, and what
    differs there."""
    a, b = np.load(a_path), np.load(b_path)
    boots = {}
    for x, name in ((a, "a"), (b, "b")):
        boots[name] = {int(x[f"b{i}_frame"]): i for i in range(int(x["n_boots"]))}
    for t in range(min(int(a["n_frames"]), int(b["n_frames"]))):
        g = lambda x, k: x[f"f{t}_{k}"]  # noqa: E731
        if g(a, "uv").shape != g(b, "uv").shape:
            return f"frame {t}: extraction: feature banks of shapes {g(a, 'uv').shape} / {g(b, 'uv').shape}"
        same_kp = np.all(g(a, "uv") == g(b, "uv"), -1) & (g(a, "octave") == g(b, "octave")) \
            & (g(a, "valid") == g(b, "valid"))
        if not same_kp.all():
            return (f"frame {t}: extraction: {int((~same_kp).sum())} of {same_kp.size} keypoints differ "
                    f"(uv, octave or valid)")
        for k in ("desc", "dmask"):
            n = _bits_differ(g(a, k), g(b, k))
            if n:
                return f"frame {t}: extraction: {n} {k} bits of {g(a, k).size * 8} differ"
        ia, ib = boots["a"].get(t), boots["b"].get(t)
        if (ia is None) != (ib is None):
            return f"frame {t}: bootstrap attempted in one run only ({ia}, {ib})"
        if ia is not None:
            ba = {k: a[f"b{ia}_{k}"] for k in ("n_matches", "ok", "leading_cam", "Mt2", "R", "t", "inliers")}
            bb = {k: b[f"b{ib}_{k}"] for k in ba}
            if int(ba["n_matches"]) != int(bb["n_matches"]):
                return f"frame {t}: bootstrap: window matches {int(ba['n_matches'])} / {int(bb['n_matches'])}"
            if ba["R"].shape != bb["R"].shape or not np.array_equal(ba["inliers"], bb["inliers"]) \
                    or not np.allclose(ba["R"], bb["R"], atol=1e-3) or not np.allclose(ba["t"], bb["t"], atol=1e-3):
                return (f"frame {t}: bootstrap: essential RANSAC by camera: inliers {ba['inliers'].tolist()} / "
                        f"{bb['inliers'].tolist()}; R differs by {_maxdiff(ba['R'], bb['R'])}, t by "
                        f"{_maxdiff(ba['t'], bb['t'])}; t {np.round(ba['t'], 4).tolist()} / "
                        f"{np.round(bb['t'], 4).tolist()}")
            if bool(ba["ok"]) != bool(bb["ok"]) or int(ba["leading_cam"]) != int(bb["leading_cam"]):
                return (f"frame {t}: bootstrap: accepted {bool(ba['ok'])} / {bool(bb['ok'])}, leading camera "
                        f"{int(ba['leading_cam'])} / {int(bb['leading_cam'])}")
        sa = [int(g(x, k)) for x in (a, b) for k in ("state", "n_matches", "n_inliers")]
        if sa[:3] != sa[3:]:
            return f"frame {t}: tracking: (state, matches, inliers) {tuple(sa[:3])} / {tuple(sa[3:])}"
        d = _maxdiff(g(a, "pose"), g(b, "pose"))
        if d > POSE_TOL:
            return f"frame {t}: tracking: the pose differs by {d} (state {sa[0]}, {sa[2]} inliers)"
    return "no difference over the frames both witnesses hold"


def _maxdiff(x, y):
    return float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max()) if x.size and \
        x.shape == y.shape else float("inf")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", choices=("torch", "jax"), default="torch")
    r.add_argument("--device", default="cpu")
    r.add_argument("--seed", type=int, default=8)
    r.add_argument("--frames", type=int, default=25)
    r.add_argument("--out", required=True)
    r.add_argument("--features", help="a witness whose features to track (the port only)")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "run":
        replay = np.load(args.features) if args.features else None
        record_run(args.package, args.device, args.seed, args.frames, args.out, replay)
    else:
        print(compare(args.a, args.b))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
