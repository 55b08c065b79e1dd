"""The benchmark's driver: one cell, one run, one process.

    python -m mzbench --workload CELL --seed N --seconds S --trace 0|1

1. Set-up: the cell's files, the card, the program, its inputs from the
   seed, warm-up. ``setup_s`` runs from the process's start to here.
2. The window: the cell's operation back to back until ``--seconds`` have
   passed; every operation that starts in the window is finished.
3. With ``--trace 1``, the window runs under ``torch.profiler`` and the
   benchmark's hooks (``hooks.py``), and the per-layer metrics are read.
4. The check: the program's state is freed, then the reference is worked
   out and every answer of the window compared with it.
5. The last line of standard output is one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``, each number compared beside its
   limit (also the last lines of standard error).

A cell is an entry of ``workloads`` in BENCHMARK.json. Its files are
found by name: the configuration's ``file``; the traffic mix
``mzbench/traffic/<traffic>.json``, which names its entry
``mzbench/entries/<entry>.py``; each metric ``mzbench/metrics/<name>.py``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "multiz_tpu")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_files(name: str, bench: dict | None = None) -> dict:
    """The cell ``name``'s workload entry, configuration and traffic mix,
    found by name."""
    bench = bench or manifest()
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    return {"cell": cell, "config": config, "mix": mix}


def metrics_of(name: str, kind: str, bench: dict | None = None) -> list:
    """The metrics of kind ``end_to_end`` or ``per_layer`` the cell
    ``name`` reports."""
    bench = bench or manifest()
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mzbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Op:
    t0: float
    t1: float
    work: int  # 0 for an operation that failed
    ok: bool
    cpu: float = 0.0  # the process's CPU seconds in the operation


@dataclass
class Run:
    """What one run measured; what the metrics' readers read."""

    name: str
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)
    ops: list = field(default_factory=list)
    hooks: object = None  # hooks.Hooks, traced runs
    trace: object = None  # devtrace.DeviceTrace, traced runs
    peaks: dict = None  # peaks.read(), traced runs


class Ctx:
    """What an entry is given: the cell's files, the seed, the device, a
    work directory under TMPDIR, ``control`` (the reference's arguments
    when the control stands in for the program, else None)."""

    def __init__(self, files, seed, device, workdir, control=None):
        self.cell, self.config, self.mix = (files["cell"], files["config"],
                                            files["mix"])
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.control = control

    def subdir(self, name: str) -> str:
        d = os.path.join(self.workdir, name)
        os.makedirs(d, exist_ok=True)
        return d


def entry_of(ctx: Ctx):
    mod = importlib.import_module(f"mzbench.entries.{ctx.mix['entry']}")
    return mod.Entry(ctx)


def window(entry, seconds: float, run: Run) -> None:
    """Operations back to back until ``seconds`` have passed; the window
    ends with the last one."""
    t_start = time.perf_counter()
    t, c = t_start, time.process_time()
    while t - t_start < seconds:
        try:
            w = entry.op()
            ok = True
        except Exception as e:  # a failed operation is counted, not fatal
            print(f"# operation failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            w, ok = 0, False
        t1, c1 = time.perf_counter(), time.process_time()
        run.ops.append(Op(t, t1, w, ok, c1 - c))
        t, c = t1, c1
    run.window = (t_start, t)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None,
             control=None, files=None) -> dict:
    """One run of cell ``name``; returns the result line as a dict."""
    t_process = time.perf_counter() if t_process is None else t_process
    bench = manifest()
    files = files or cell_files(name, bench)
    os.environ.pop("MZ_TIME", None)
    workdir = tempfile.mkdtemp(prefix="mzbench-")
    try:
        return _run(name, seed, seconds, trace, device, t_process, control,
                    files, bench, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(name, seed, seconds, trace, device, t_process, control, files,
         bench, workdir) -> dict:
    import torch

    ctx = Ctx(files, seed, device, workdir, control)
    entry = entry_of(ctx)
    entry.setup()
    run = Run(name=name)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_process
    if trace:
        from . import devtrace, peaks
        from .hooks import Hooks

        run.peaks = peaks.read() if cuda else None
        with Hooks(entry.yama_pack) as run.hooks:
            if cuda:
                with devtrace.Recorder() as rec:
                    window(entry, seconds, run)
                    rec.stop()
                run.trace = rec.trace
                run.trace.window = run.window
            else:
                window(entry, seconds, run)
    else:
        window(entry, seconds, run)
        if cuda:
            torch.cuda.synchronize()
    dev = device_info(device, ctx.cell["chips"])
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"mzbench: modules loaded in the run: {found}")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(name, kind, bench):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.window[1] - run.window[0]
    # the program's state goes before the reference runs
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = entry.check()
    check_s = time.perf_counter() - t0
    print(f"# check {check_s:.3f} s", file=sys.stderr)
    failed = sum(not o.ok for o in run.ops)
    correct = failed == 0 and bool(run.ops) and all(
        v <= lim for v, lim in checks.values())
    line = {"correct": correct, "attempted": len(run.ops), "failed": failed,
            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        line["breakdown"] = breakdown(run)
    line["op_s"] = op_seconds(run.ops)
    line["check_s"] = check_s
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def op_seconds(ops) -> dict:
    """The operations' seconds, for the record: the first, the median,
    the last and the largest, and the median of the process's CPU
    seconds in each (``cpu_median``)."""
    s = [o.t1 - o.t0 for o in ops]
    if not s:
        return {}
    return {"first": s[0], "median": sorted(s)[len(s) // 2], "last": s[-1],
            "max": max(s),
            "cpu_median": sorted(o.cpu for o in ops)[len(s) // 2]}


def device_info(device: str, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def breakdown(run: Run) -> dict:
    """The device operations that took most time, and the window's idle
    time by what the host was doing (the benchmark's spans), ten each."""
    ops = sorted(run.trace.by_name().items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle_by_span(run)[:10]]}


def overlap(gaps, spans) -> float:
    """Seconds that sorted disjoint ``gaps`` share with sorted disjoint
    ``spans``."""
    tot, j = 0.0, 0
    for g0, g1 in gaps:
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < g1:
            tot += min(g1, spans[k][1]) - max(g0, spans[k][0])
            k += 1
    return tot


def idle_by_span(run: Run) -> list:
    """The window's idle seconds by what the host was doing:
    ``stream.submit`` and ``stream.finish`` (the benchmark's spans around
    the DP stream), ``op.rest`` (inside an operation, outside the stream:
    for a tba, its planning) or ``between`` operations."""
    gaps = run.trace.gaps()
    ops = [(o.t0, o.t1) for o in run.ops]
    tot = {n: overlap(gaps, sorted(v)) for n, v in run.hooks.spans.items()}
    in_ops = overlap(gaps, ops)
    tot["op.rest"] = in_ops - sum(tot.values())
    tot["between"] = sum(g1 - g0 for g0, g1 in gaps) - in_ops
    return sorted(tot.items(), key=lambda kv: -kv[1])


def emit(line: dict) -> None:
    """The checks' lines last on standard error, then the result line
    last on standard output."""
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


CORES = 4  # the cores a run is held to: the main thread, the host lane's
# two workers (MZ_HOST_DP_THREADS) and the CUDA runtime's own threads


def steady_host(cores: int = CORES) -> list:
    """Hold the process to ``cores`` of the cores it may use, one thread
    of each physical core where the host says which threads share one,
    and to one thread in each numeric library's pool, before any of them
    starts. Returns the cores."""
    for v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[v] = "1"
    allowed = sorted(os.sched_getaffinity(0))
    first, seen = [], set()
    for c in allowed:
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/"
                      "thread_siblings_list") as fh:
                core = fh.read().strip()
        except OSError:
            core = str(c)
        if core not in seen:
            seen.add(core)
            first.append(c)
    pick = (first if len(first) >= cores else allowed)[:cores]
    os.sched_setaffinity(0, pick)
    return pick


def main(argv=None, t_process: float | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mzbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    files = cell_files(a.workload)
    chips = int(files["cell"]["chips"])
    cores = steady_host()
    import torch

    torch.set_num_threads(1)
    print(f"# cores {cores}", file=sys.stderr)

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mzbench: {a.workload} needs {chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                    t_process, files=files)
    emit(line)
    return 0
