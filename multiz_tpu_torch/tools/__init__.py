"""Measurement tools of the port, run with ``python -m``: ``bench``
(batched DP band-cells/s), ``bench_pipeline`` (tba per DP mode),
``shard_bench`` (the sharded tba), ``route_sweep`` (the DP stream's
routing thresholds over tba runs), ``profile_pack`` (the packed path's
stage profile), ``scaling_proxy`` (its two-process scaling) and
``kernel_ab``; and the modules they and the smoke test share: ``sim``
(the synthetic genome and pairwise-MAF simulator), ``fasta_pipeline``
(the TBA workflow from FASTA files) and ``kernel_cases``."""

import contextlib
import os
import subprocess

# Cycles of the spin kernel (torch.cuda._sleep) that holds the stream
# before each timed run, about 10 ms at 1.98 GHz: the host enqueues the
# runs meanwhile, so CUDA events time the card's work back to back and
# not the host's rate of launches (a wrapper's Python and ctypes cost is
# tens of microseconds, longer than many of its kernels).
HOLD_CYCLES = 20_000_000


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device milliseconds of fn() over reps runs between CUDA
    events, after one warm run unless ``warm`` is false, enqueued while a
    spin kernel of HOLD_CYCLES holds the stream."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def run_trees(child: str, trees, path: str, reps: int, what: str) -> list:
    """Run the script ``child`` in a process of its own for each
    checkout root in ``trees``, in the order given, as ``python -c child
    ROOT path reps HOLD_CYCLES`` from ROOT, with this checkout's
    ``cuda_ms`` in place of its ``#CUDA_MS#`` line (a tree may lack the
    helper). Prints each run's last line, a JSON object, as it comes;
    raises if a run fails or their ``digest``s differ. Returns the
    objects."""
    import inspect
    import json
    import sys

    child = child.replace("#CUDA_MS#", inspect.getsource(cuda_ms))
    lines = []
    for root in trees:
        root = os.path.abspath(root)
        res = subprocess.run(
            [sys.executable, "-c", child, root, path, str(reps),
             str(HOLD_CYCLES)],
            cwd=root, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"{what}: {root} failed:\n"
                               f"{res.stderr[-3000:]}")
        line = res.stdout.strip().splitlines()[-1]
        lines.append(json.loads(line))
        print(line, flush=True)
    if len({l["digest"] for l in lines}) != 1:
        raise AssertionError(f"{what}: the trees' outputs differ")
    return lines


def card_label(device) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, for
    a CUDA ``device`` (a torch.device); "cpu" for the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


@contextlib.contextmanager
def environ(**values):
    """Set the environment variables ``values`` while inside (a value of
    None removes its variable); each is restored (or removed) on exit."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# The packed stream's kernels by the names the tools report them under
# (one of each per bucket). The bench, shard_bench, route_sweep,
# profile_pack, scaling_proxy and the perf guard launch only these; the
# full-row DP's kernels (ops/yama_full.py, mode full) count as
# yama_full_dp and yama_full_tb, and the runs of that path read and hold
# their wrappers' counts themselves.
PACKED = ("yama_dp", "yama_tb", "yama_prep")


def kernel_counters() -> dict:
    """Each kernel's wrapper by the name the tools report it under; each
    wrapper's ``launches`` counts its kernel's launches."""
    from ..ops.prep import prep
    from ..ops.yama_dp import dp_forward
    from ..ops.yama_full import traceback_core, yama_core
    from ..ops.yama_tb import traceback

    return {"yama_dp": dp_forward, "yama_tb": traceback, "yama_prep": prep,
            "yama_full_dp": yama_core, "yama_full_tb": traceback_core}


def reset_launches() -> None:
    """Set every kernel's launch count to 0, its counts by path too."""
    for wrapper in kernel_counters().values():
        wrapper.launches = 0
        if hasattr(wrapper, "paths"):
            wrapper.paths = dict.fromkeys(wrapper.paths, 0)


def launches() -> dict:
    """The launch counts of the packed stream's kernels, by name."""
    counters = kernel_counters()
    return {name: counters[name].launches for name in PACKED}


def check_launches(counts: dict, device, what: str) -> None:
    """On a CUDA ``device``, raise unless every packed kernel launched in
    ``counts`` (a ``launches()`` dict, or a sum of them) and the prep
    once for each DP launch (one of each per bucket)."""
    if device.type != "cuda":
        return
    if (min(counts[n] for n in PACKED) <= 0
            or counts["yama_prep"] != counts["yama_dp"]):
        raise AssertionError(f"{what}: kernel launches {counts}")
