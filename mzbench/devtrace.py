"""The device's timeline over the measured window, from ``torch.profiler``.

The profiler records the card's kernels and copies (CUPTI) and one host
marker around the window; the chrome trace it writes is read back here
into plain intervals. The marker ties the trace's clock to the host's
``time.perf_counter``, so that idle gaps can be laid beside the
benchmark's own host spans.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

MARKER = "mzbench.window"
# kineto's categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_name(name: str) -> str:
    """The kernel's identifier from a demangled name such as
    ``void (anonymous namespace)::yama_dp_warp<2>(int const*, ...)``."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0].strip().split("::")[-1]


@dataclass
class DeviceTrace:
    """Device intervals, in seconds on the host's perf_counter clock."""

    events: list = field(default_factory=list)  # (name, cat, start, end)
    window: tuple = (0.0, 0.0)

    def busy(self) -> list:
        """The union of every device interval inside the window, as
        sorted disjoint (start, end) pairs."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1)) for _, _, s, e in self.events
                       if e > w0 and s < w1)
        out: list = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def gaps(self) -> list:
        """The idle (start, end) intervals of the window."""
        w0, w1 = self.window
        out, t = [], w0
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if w1 > t:
            out.append((t, w1))
        return out

    def kernel_s(self, names) -> float:
        """Seconds of the kernels whose identifier is in ``names``."""
        names = set(names)
        return sum(e - s for n, c, s, e in self.events
                   if c == "kernel" and kernel_name(n) in names)

    def by_name(self) -> dict:
        """Seconds by kernel identifier or copy kind."""
        tot: dict = {}
        for n, c, s, e in self.events:
            k = kernel_name(n) if c == "kernel" else n
            tot[k] = tot.get(k, 0.0) + (e - s)
        return tot


class Recorder:
    """``torch.profiler`` over a window: ``with Recorder() as rec:``
    around the window, then ``rec.trace`` (a DeviceTrace)."""

    def __init__(self):
        self.trace = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(MARKER)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self._mark.__enter__()
        return self

    def stop(self) -> None:
        """Closes the window (the work is synchronised by then)."""
        import torch

        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.t1 = time.perf_counter()

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = self._read()
        return False

    def _read(self) -> DeviceTrace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        return parse(events, self.t0, self.t1)


def parse(events, t0: float, t1: float) -> DeviceTrace:
    """A DeviceTrace from chrome-trace events, on the host clock: the
    marker's start is taken to be ``t0``."""
    mark = [e for e in events if e.get("ph") == "X"
            and e.get("name") == MARKER and e.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("profiler trace has no window marker")
    base = float(mark[0]["ts"]) * 1e-6 - t0
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"]) * 1e-6 - base
        out.append((e.get("name", ""), e["cat"], s,
                    s + float(e.get("dur", 0.0)) * 1e-6))
    return DeviceTrace(events=out, window=(t0, t1))


def idle_pct(run):
    """100 x the share of the window in which the card ran no kernel and
    no copy; None without a trace."""
    if run.trace is None:
        return None
    w0, w1 = run.window
    return 100.0 * (1.0 - run.trace.busy_s() / (w1 - w0))
