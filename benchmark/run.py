"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

The cell is found by name in BENCHMARK.json at the checkout's root: its
configuration (benchmark/configs/<config>.json), its traffic mix
(benchmark/traffic/<traffic>.json, which names the runner in
benchmark/runners/ that plays it) and the limits of its output check
(benchmark/limits/<workload>.json). With --trace 0 the line carries the
cell's end-to-end metrics; with --trace 1 its per-layer metrics, each read
by benchmark/metrics/<metric>.py from the run's spans, counters and
profiler trace, and the trace's busy time and breakdown.

Set-up (world, weights, warm-up) counts in setup_s, from the process's
start to the window's; the window lasts --seconds; the output check runs
after it, against the plain references in benchmark/reference/. The
process runs one intra-op thread; once set-up ends, each Python thread is
pinned to a CPU of its own and the garbage collector's generations are
frozen; the line's "host" key gives a fixed interpreter loop's time before
and after the window (the host's speed, which the host-bound cells
follow). The run needs CUDA and as many cards as the cell asks for:
without them it exits 2 and prints no result. It exits 3, with no result, when JAX or the JAX
package is loaded in the process once the window has closed.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
# every compiler cache of the run at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's math libraries single-threaded,
# so no idle pool spins beside the interpreter
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "multicol_slam_tpu")


def process_start_time() -> float:
    """time.time() at which this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark's own folder, by file path (metric files
    carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic, limits
    and metrics, found by name."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "benchmark" / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self.reports(m)]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if self.reports(m) and m["moves"] in names]
        self.root = root

    def reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


class Context:
    """What a runner gets: the cell, the seed, the window, the device, and
    whether to trace."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, start_wall: float,
                 control: bool = False):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        # the output check's control: the reference in the precision below
        # the configuration's stands in the program's place
        self.control = control
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        # the process's start (time.time()) on the perf_counter clock
        self.start_perf = time.perf_counter() - (time.time() - start_wall)

    def setup_s(self, window_start_perf: float) -> float:
        return window_start_perf - self.start_perf


class Outcome:
    """A runner's result: the work of the window, the end-to-end metrics,
    what the per-layer readers read, and the numbers compared with their
    limits (name -> value; each limit is in the cell's limits file)."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.metrics: Dict[str, float] = {}
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.trace: Optional[dict] = None
        self.compared: Dict[str, float] = {}
        self.errors: List[str] = []
        self.memory_peak_bytes = 0
        self.host: Dict[str, float] = {}


def host_loop_ms() -> float:
    """Milliseconds of a fixed interpreter loop: the host's speed as the
    program's dispatch feels it."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def pin_threads() -> Dict[str, int]:
    """Each live Python thread of the process (the caller first) on a CPU of
    its own, from the second CPU of the process's set on."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return {}
    me = threading.current_thread()
    others = [t for t in threading.enumerate() if t is not me and t.native_id is not None]
    pinned = {}
    for cpu, t in zip(cpus[1:], [me] + others):
        os.sched_setaffinity(t.native_id, {cpu})
        pinned[t.name] = cpu
    return pinned


def open_window(out: Outcome) -> float:
    """The end of set-up: pin the threads, collect and freeze the garbage
    collector's generations (set-up's objects are never scanned again),
    read the host's speed, and return the window's start (perf_counter)."""
    pin_threads()
    gc.collect()
    gc.freeze()
    out.host["loop_ms_before"] = host_loop_ms()
    return time.perf_counter()


def close_window(out: Outcome) -> None:
    """After the window: the host's speed again, and the collector's
    generations back, so that the program's state can be freed."""
    out.host["loop_ms_after"] = host_loop_ms()
    gc.unfreeze()


def card_name_and_limit(device) -> tuple:
    import torch

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    limit = None
    if device.type == "cuda":
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                                  "-i", str(device.index or 0)], capture_output=True, text=True, timeout=30)
            limit = float(out.stdout.strip().splitlines()[0])
        except (OSError, ValueError, IndexError, subprocess.SubprocessError):
            limit = None
    return name, limit


def judge(outcome: Outcome, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every compared number at or under
    its limit, every limit met by a number, and no error."""
    rows = []
    ok = not outcome.errors
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = outcome.compared.get(name)
        rows.append((name, value, limit))
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, rows


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None, start_wall: Optional[float] = None,
             bench: Optional[dict] = None, root: Path = ROOT, overrides: Optional[dict] = None,
             control: bool = False) -> dict:
    """Run the cell and return the result line as a dict. `device` None: the
    card, after the checks on CUDA and the card count. `overrides`
    ({"config": {...}, "traffic": {...}}, merged one level deep) resize a
    cell for the CPU tests. `control`: the output check's control run
    (benchmark/control.py)."""
    import torch

    start_wall = process_start_time() if start_wall is None else start_wall
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    cell = Cell(bench, workload, root)
    for key, extra in (overrides or {}).items():
        target = getattr(cell, key)
        for k, v in extra.items():
            target[k] = {**target[k], **v} if isinstance(v, dict) and isinstance(target.get(k), dict) else v
    if device is None:
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} CUDA device(s); "
                         f"cuda available {torch.cuda.is_available()}, "
                         f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    ctx = Context(cell, seed, seconds, trace, device, start_wall, control)
    runner = load_module(root / "benchmark" / "runners" / f"{cell.traffic['runner']}.py",
                         f"benchmark_runner_{cell.traffic['runner']}")
    outcome = runner.run(ctx)
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded in the run's process: {', '.join(found)}")
    correct, rows = judge(outcome, cell.limits)
    kind, power = card_name_and_limit(device)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(outcome.memory_peak_bytes), "power_limit_w": power}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if outcome.trace is not None:
            dev["busy_s"] = outcome.trace["busy_s"]
            dev["window_s"] = outcome.trace["window_s"]
    else:
        metrics = {m["name"]: {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in outcome.metrics}
    line = {"correct": bool(correct), "attempted": int(outcome.attempted), "failed": int(outcome.failed),
            "metrics": metrics, "device": dev}
    if trace and outcome.trace is not None:
        line["breakdown"] = outcome.trace["breakdown"]
    line["errors"] = outcome.errors[:5]
    line["host"] = outcome.host
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return line


class NoCard(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def main(argv=None) -> int:
    start_wall = process_start_time()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    try:
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), start_wall=start_wall)
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    except Forbidden as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
