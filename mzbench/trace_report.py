"""One traced run of a cell, reported by the program's own spans.

    python -m mzbench.trace_report --workload CELL --seed N --seconds S \\
        [--cost K] [--out DIR]

Runs the cell as ``python -m mzbench ... --trace 1`` does (the same
harness, host and window) and prints, besides its result line's
per-layer metrics:

* the self time of every program span and the seconds of every program
  counter, per tba (``multiz_tpu_torch/trace.py``);
* the window's device-idle time by the innermost program span
  (``progtrace.idle_by_program_span``) beside the harness's own
  ``breakdown.idle_gaps``;
* the accounting check: the seven planning metrics summed against
  ``host_plan_s_per_tba``.

With ``--cost K``, it then times K tbas of the cell's region with
``MZ_TIME`` unset and K with it set, in turns (off, on, on, off, ...) in
the same process: the tracing's cost. The report is printed as JSON,
and with ``--out DIR`` also written to
``DIR/trace_report-<cell>-<seed>.json``.
``--device cpu --region-bases B`` rehearses it on the CPU at a small
region.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

PLANNING = ("tree_s_per_tba", "maf_read_s_per_tba", "project_s_per_tba",
            "threading_s_per_tba", "merge_scan_s_per_tba",
            "preyama_s_per_tba", "maf_render_s_per_tba")


def by_name(run, T) -> dict:
    """{span name: [spans, self seconds]} over the window's spans and
    {counter: [count, seconds, cells]}, each per tba."""
    recs = T.spans()
    selfs = T.self_times(recs)
    w0, w1 = run.window
    idx = [i for i, s in enumerate(recs)
           if selfs[i] is not None and w0 <= s.t0 < w1]
    n = max(1, sum(recs[i].name == "tba" and recs[i].parent < 0
                   for i in idx))
    spans: dict = {}
    for i in idx:
        e = spans.setdefault(recs[i].name, [0, 0.0])
        e[0] += 1
        e[1] += selfs[i]
    return {"tbas": n,
            "self_s_per_tba": {k: [c / n, s / n] for k, (c, s) in
                               sorted(spans.items(), key=lambda kv: -kv[1][1])},
            "counters_per_tba": {k: [c.count / n, c.seconds / n, c.cells / n]
                                 for k, c in T.counters().items()}}


def cost(files, seed, device, k, workdir) -> dict:
    """Walls of ``k`` tbas (with their rendering) with MZ_TIME unset and
    ``k`` with it set, in turns, on a fresh entry of the cell."""
    from mzbench import harness

    entry = harness.entry_of(harness.Ctx(files, seed, device, workdir))
    entry.setup()
    walls: dict = {"off": [], "on": []}
    order = [("off", "on", "on", "off")[i % 4] for i in range(2 * k)]
    with open(os.devnull, "w") as null:
        for side in order:
            if side == "on":
                os.environ["MZ_TIME"] = "1"
            else:
                os.environ.pop("MZ_TIME", None)
            with contextlib.redirect_stdout(null):
                t0 = time.perf_counter()
                entry.one(entry.ds)
                walls[side].append(time.perf_counter() - t0)
    os.environ.pop("MZ_TIME", None)
    med = {s: statistics.median(w) for s, w in walls.items()}
    return {"order": order, "walls": walls, "median": med,
            "on_over_off": med["on"] / med["off"] - 1.0}


def main(argv=None) -> int:
    t_process = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python -m mzbench.trace_report")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--region-bases", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)

    from mzbench import harness, progtrace

    harness.steady_host()
    import torch

    torch.set_num_threads(1)
    files = harness.cell_files(a.workload)
    if a.region_bases:
        files["mix"] = dict(files["mix"], region_bases=a.region_bases)
    kept = []
    window = harness.window

    def keep(entry, seconds, run):  # the run itself, for the readers below
        kept.append(run)
        return window(entry, seconds, run)

    harness.window = keep
    try:
        line = harness.run_cell(a.workload, a.seed, a.seconds, True,
                                a.device, t_process, files=files)
    finally:
        harness.window = window
    report = {"cell": a.workload, "seed": a.seed, "correct": line["correct"],
              "device": line["device"],
              "metrics": {k: v["value"] for k, v in line["metrics"].items()},
              "harness_idle_gaps": line.get("breakdown", {}).get("idle_gaps")}
    T = progtrace.program_trace()
    if kept and T is not None:
        run = kept[0]
        report.update(by_name(run, T))
        report["idle_by_program_span"] = progtrace.idle_by_program_span(run)
    m = report["metrics"]
    if all(k in m for k in PLANNING + ("host_plan_s_per_tba",)):
        total = sum(m[k] for k in PLANNING)
        report["accounting"] = {
            "planning_sum_s": total, "host_plan_s": m["host_plan_s_per_tba"],
            "ratio": total / m["host_plan_s_per_tba"]}
    if a.cost:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="mzbench-cost-") as d:
            report["cost"] = cost(files, a.seed, a.device, a.cost, d)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        path = os.path.join(a.out,
                            f"trace_report-{a.workload}-{a.seed}.json")
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1)
    json.dump(report, sys.stdout, indent=1)
    print()
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
