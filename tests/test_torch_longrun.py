"""The long run: `python3 -m multicol_slam_tpu_torch.longrun` against the
repository's `longrun.py` (the JAX package's), both on the CPU.

The full run is 1600 frames of an out-and-back corridor (the card runs it;
PERF.md). Here both entries track the first 30 frames of the 1600-frame
run's world: the port always makes that world, and the JAX entry, which
makes its world for --frames, gets make_world with n_frames=1600. A world
made for 30 frames packs the corridor's 6000 landmarks into 5.75 m and
neither package initializes on it. The JAX entry's persistent compile cache
and platform setting are kept out of the rest of the session. Bounds: the same record and summary keys, the same record frames and
capacities; frames tracked within 2 of each other (the two bootstraps draw
different RANSAC samples); the LONGRUN.jsonl file holds what was printed.
"""
import importlib
import json
import os
import sys

import jax
import pytest
import torch

import multicol_slam_tpu.io.synthetic as jsynthetic
import multicol_slam_tpu.utils.jaxcache as jaxcache
from multicol_slam_tpu_torch import longrun

N_FRAMES = 30
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _full_world(make_world):
    return lambda **kw: make_world(**dict(kw, n_frames=longrun.FULL_RUN))


def _read(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("longrun")
    mp = pytest.MonkeyPatch()
    n = torch.get_num_threads()
    platforms = jax.config.jax_platforms
    torch.set_num_threads(1)
    try:
        mp.setattr(jsynthetic, "make_world", _full_world(jsynthetic.make_world))
        mp.setattr(jaxcache, "enable_compile_cache", lambda *a, **k: None)
        mp.syspath_prepend(ROOT)
        jlongrun = importlib.import_module("longrun")   # the repository's root longrun.py
        assert jlongrun.main(["--frames", str(N_FRAMES), "--out", str(out / "jax.jsonl")]) == 0
        assert longrun.main(["--frames", str(N_FRAMES), "--out", str(out / "port.jsonl")], device="cpu") == 0
    finally:
        torch.set_num_threads(n)
        jax.config.update("jax_platforms", platforms)
        mp.undo()
        sys.modules.pop("longrun", None)
    return _read(out / "jax.jsonl"), _read(out / "port.jsonl")


def test_same_records(runs):
    jax_rows, port_rows = runs
    assert len(port_rows) == len(jax_rows) == N_FRAMES // longrun.RECORD_EVERY + 1
    for a, b in zip(port_rows, jax_rows):
        assert list(a) == list(b)
    for a, b in zip(port_rows[:-1], jax_rows[:-1]):
        assert (a["frame"], a["kf_capacity"], a["pt_capacity"]) == (b["frame"], b["kf_capacity"], b["pt_capacity"])
    summary = port_rows[-1]
    assert summary["summary"] and summary["n_frames"] == N_FRAMES and summary["kf_capacity"] == 256


def test_tracked_frames_agree(runs):
    j, p = runs[0][-1], runs[1][-1]
    assert j["tracked"] >= N_FRAMES - 5 and abs(p["tracked"] - j["tracked"]) <= 2, (p, j)
    assert p["max_keyframes_live"] >= 5 and p["final_pt"] > 0
