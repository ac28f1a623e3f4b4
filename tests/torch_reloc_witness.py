"""Relocalization on the card's recipe, witnessed by the JAX package: its
`_relocalize` (the branch without a vocabulary) on the CPU, against the map
and frames that the port's system built on the card.

    python3 chip_smoke.py --reloc-dump reloc.npz     # on the card
    python tests/torch_reloc_witness.py reloc.npz [--keys 32]

chip_smoke.py's dump holds the card's final map store, the rig, the
extractor settings, the features of its relocalization frames, their
track-time poses and the card's outcome on each. Here both packages load
that map on the CPU and relocalize each frame under `--keys` RANSAC keys:
the JAX package with its own draws, the port (device="cpu") with the same
hypotheses as the JAX package at that key. A line a frame and key (outcome,
confirmed inliers, the accepted pose's distance from the frame's track-time
pose), then a summary a frame: how often each package relocalized, and how
often at a pose more than WRONG_M away. The relocalization is small (one
frame's 3 x 400 features against the map); the map and features come from
the card, so nothing here runs at the recipe's full size."""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))   # the repo's root

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from multicol_slam_tpu.models.camera import OmniCamera as JCamera  # noqa: E402
from multicol_slam_tpu.models.rig import MultiCamRig as JRig  # noqa: E402
from multicol_slam_tpu.ops.ransac import sample_indices  # noqa: E402
from multicol_slam_tpu.slam import system as jsys  # noqa: E402
from multicol_slam_tpu.slam.features import FrameFeatures as JFeatures  # noqa: E402
from multicol_slam_tpu.slam.local_mapping import _bucket  # noqa: E402
from multicol_slam_tpu.slam.map_store import MapConfig as JMapConfig  # noqa: E402
from multicol_slam_tpu.slam.map_store import MapStore as JMapStore  # noqa: E402
from multicol_slam_tpu.utils.config import ExtractorSettings as JExtractor  # noqa: E402
from multicol_slam_tpu.utils.config import SlamSettings as JSettings  # noqa: E402
from multicol_slam_tpu_torch import convert  # noqa: E402
from multicol_slam_tpu_torch.slam import system as tsys  # noqa: E402
from multicol_slam_tpu_torch.slam.features import FrameFeatures  # noqa: E402
from multicol_slam_tpu_torch.slam.map_store import MapConfig, MapStore  # noqa: E402
from multicol_slam_tpu_torch.utils.config import ExtractorSettings, SlamSettings  # noqa: E402

WRONG_M = 0.1   # the track-time poses are within a few cm of the world's
CAMERA_FIELDS = ("pol", "invpol", "cde", "pp", "wh")


def jax_reloc_draws(key: int):
    """The JAX system's relocalization draws at PRNGKey(key): fold_in(key,
    frame_id) over the rows padded to a bucket of 64 (system.py:860-878)."""
    def draw(frame_id, n):
        pS = _bucket(n, 64)
        w = (np.arange(pS) < n).astype(np.float32)
        idx = sample_indices(jax.random.fold_in(jax.random.PRNGKey(key), frame_id), 160, 6, pS,
                             weights=jnp.asarray(w / n))
        return torch.tensor(np.asarray(idx))
    return draw


def _fill_store(store, d, meta):
    for name in d.files:
        if name.startswith("store_"):
            attr = name[len("store_"):]
            setattr(store, attr, np.array(d[name], dtype=getattr(store, attr).dtype))
    store.n_kf, store.n_pt_alloc = meta["n_kf"], meta["n_pt_alloc"]
    store._free_kf, store._free_pt = list(meta["free_kf"]), list(meta["free_pt"])
    return store


def _settings(cls_slam, cls_ex, extractor):
    names = {f.name for f in dataclasses.fields(cls_ex)}
    return cls_slam(fps=25.0, extractor=cls_ex(**{k: v for k, v in extractor.items() if k in names}))


def load(path):
    d = np.load(path)
    meta = json.loads(str(d["meta"]))
    cams = [d[f"rig_{k}"] for k in CAMERA_FIELDS]
    mc = d["rig_mc_cayley"]
    js = jsys.MultiColSLAM(JRig.from_cayley(JCamera(*(jnp.asarray(a) for a in cams)), jnp.asarray(mc)),
                           _settings(JSettings, JExtractor, meta["extractor"]), JMapConfig(**meta["cfg"]),
                           use_loop_closing=False)
    ts = tsys.MultiColSLAM(convert.rig_from_numpy(*cams, mc, device="cpu"),
                           _settings(SlamSettings, ExtractorSettings, meta["extractor"]), MapConfig(**meta["cfg"]),
                           use_loop_closing=False, device="cpu")
    for slam, store in ((js, JMapStore(JMapConfig(**meta["cfg"]))), (ts, MapStore(MapConfig(**meta["cfg"])))):
        slam.store = slam.mapper.store = _fill_store(store, d, meta)
        slam.last_kf_id, slam.frame_id, slam.state = meta["last_kf_id"], meta["frame_id"], jsys.WORKING
    feats = {}
    for k in meta["frames"]:
        fields = {f.name: d[f"frame{k}_{f.name}"] for f in dataclasses.fields(FrameFeatures)}
        feats[k] = (JFeatures(**{n: jnp.asarray(a) for n, a in fields.items()}),
                    convert.frame_features_from_numpy(**fields, device="cpu"))
    return meta, js, ts, feats


def relocalize(mod, slam, f, track_pose):
    m = mod.FrameMetrics(slam.frame_id, 0.0, mod.LOST, slam.last_pose.copy())
    ok = bool(slam._relocalize(f, m))
    dist = float(np.linalg.norm(slam.last_pose[3:] - track_pose[3:])) if ok else float("nan")
    return ok, int(m.n_inliers), dist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", help="chip_smoke.py --reloc-dump's file")
    ap.add_argument("--keys", type=int, default=32, help="RANSAC keys 0 .. keys-1")
    args = ap.parse_args(argv)
    meta, js, ts, feats = load(args.dump)
    summary = {}
    for k in meta["frames"]:
        track_pose = np.asarray(meta["track_pose"][str(k)], np.float32)
        card = meta["card"][str(k)]
        print(f"frame {k}: on the card (the port, its own draws): relocalized {card['ok']}, "
              f"{card['n_inliers']} confirmed inliers, {card['dist']:.4f} m")
        rows = []
        for key in range(args.keys):
            js.key = jax.random.PRNGKey(key)
            ts.reloc_sampler = jax_reloc_draws(key)
            rj = relocalize(jsys, js, feats[k][0], track_pose)
            rt = relocalize(tsys, ts, feats[k][1], track_pose)
            rows.append((rj, rt))
            print(f"frame {k} key {key:2d}: JAX {rj[0]!s:5} {rj[1]:4d} inliers {rj[2]:.4f} m | "
                  f"port (JAX's draws) {rt[0]!s:5} {rt[1]:4d} inliers {rt[2]:.4f} m")
        summary[k] = {}
        for name, i in (("jax", 0), ("port", 1)):
            res = [r[i] for r in rows]
            good = [r for r in res if r[0] and r[2] <= WRONG_M]
            wrong = [r for r in res if r[0] and r[2] > WRONG_M]
            summary[k][name] = dict(keys=len(res), relocalized=len(good) + len(wrong), wrong=len(wrong),
                                    wrong_inliers=sorted(r[1] for r in wrong),
                                    right_inliers=sorted(r[1] for r in good),
                                    wrong_m=sorted(round(r[2], 4) for r in wrong))
        summary[k]["same_outcome"] = sum(r[0][0] == r[1][0] for r in rows)
    print(json.dumps({"reloc_witness": summary, "wrong_m": WRONG_M}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
