"""CPU tests of the benchmark's harness: BENCHMARK.json against the
contract, the cells' files found by name, no JAX anywhere in a run, the
world's determinism, the result line, and the BA cell's output check
failing on a broken solver.

    python3 -m pytest benchmark/ -q
"""
from __future__ import annotations

import ast
import json
import math
import re
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run as harness
from benchmark.reference.geometry import Rig
from benchmark.world import RoomWorld

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL_BA = {"config": {"problem": {"n_kfs": 8, "n_points": 2000, "n_obs": 20000}}}


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.Cell(BENCH, workload, ROOT)
    assert cell.config["name"] == cell.workload["config"]
    assert (ROOT / "benchmark" / "runners" / f"{cell.traffic['runner']}.py").is_file()
    assert {k for k in cell.limits if not k.startswith("_")}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        reader = harness.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py", "m_" + m["name"])
        assert reader.read(harness.Outcome()) is None        # nothing to read: nothing returned


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_in_the_benchmark_sources():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)
        if path.parent.name == "reference":
            assert "multicol_slam_tpu_torch" not in tops, path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "multicol_slam_tpu_torch_fake", object())
    monkeypatch.delitem(sys.modules, "multicol_slam_tpu", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "multicol_slam_tpu.ops", object())
    assert harness.forbidden_modules() == ["multicol_slam_tpu"]


def test_world_is_made_from_the_seed():
    spec = json.loads((ROOT / "benchmark/configs/lafida3-orb.json").read_text())
    rig = Rig(spec["rig"], "cpu")
    a = RoomWorld(spec["world"], rig, 2 ** 31 + 3, "cpu", n_render=2)
    b = RoomWorld(spec["world"], rig, 2 ** 31 + 3, "cpu", n_render=2)
    c = RoomWorld(spec["world"], rig, 7, "cpu", n_render=2)
    ia, ib, ic = (torch.stack(w.images) for w in (a, b, c))
    assert torch.equal(ia, ib) and torch.equal(a.textures, b.textures)
    assert not torch.equal(ia, ic)
    assert ia.dtype == torch.uint8 and ia.shape == (2, 3, 480, 754)
    assert (ia != 20).float().mean() > 0.05                   # landmarks in view
    assert torch.equal(a.frame(a.period + 1), a.images[1])     # laps repeat
    assert torch.equal(a.frame(5), b.render(5))                # later frames rendered when asked for


def test_run_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoCard):
        harness.run_cell("ba-large", 1, 1.0, False)


def test_result_line_keys_and_checks_last():
    line = harness.run_cell("ba-large", 2 ** 31 + 17, 2.0, False, device="cpu", overrides=SMALL_BA)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"ba_lm_iters_per_s", "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"cost_gap", "cost_claim_gap", "pose_gap"}
    traced = harness.run_cell("ba-large", 2 ** 31 + 17, 2.0, True, device="cpu", overrides=SMALL_BA)
    assert "window_s" in traced["device"] and "breakdown" in traced
    assert traced["checks"] == line["checks"]


def _broken_solver(kind):
    from multicol_slam_tpu_torch.optim import lm

    real = lm.lm_solve_interruptible

    def solve(params, obs, free, config, **kw):
        if kind == "unchanged":
            real(params, obs, free, config, **kw)
            r, z = lm.residuals_only(params, obs)
            return params, lm.robust_cost(r, z, obs, config.huber_delta)
        if kind == "half_rows":
            keep = torch.arange(obs.valid.shape[0]) % 2 == 0
            return real(params, obs._replace(valid=obs.valid & keep), free, config, **kw)
        p, cost = real(params, obs, free, config, **kw)
        return p, cost * 0.99                                 # the answer altered where it is made
    return solve


@pytest.mark.parametrize("kind", ["unchanged", "half_rows", "altered_cost"])
def test_ba_check_fails_on_a_broken_solver(monkeypatch, kind):
    from multicol_slam_tpu_torch.optim import lm

    monkeypatch.setattr(lm, "lm_solve_interruptible", _broken_solver(kind))
    line = harness.run_cell("ba-large", 2 ** 31 + 23, 2.0, False, device="cpu", overrides=SMALL_BA)
    assert not line["correct"], line["checks"]
    assert line["attempted"] >= 1


def test_every_limit_is_a_finite_number_under_one():
    for path in (ROOT / "benchmark" / "limits").glob("*.json"):
        for name, limit in json.loads(path.read_text()).items():
            if not name.startswith("_"):
                assert math.isfinite(limit) and 0 < limit < 1, (path, name)
