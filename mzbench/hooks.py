"""What a traced run reads from the program, from the benchmark's side.

``Hooks`` wraps, for the length of the window, the calls into the
program's DP stream (``multiz_tpu_torch/ops/yama_pack.py``) and restores
them after:

* host spans around ``PackedDPStream.submit`` and ``.finish``;
* the jobs of every device launch, from the arguments of ``pack_wire``;
* the stream's own stage split, which it prints with ``MZ_TIME`` set
  (``[MZ_TIME] key=value`` lines, seconds), read from its output;
* the stream's route counters (``route_stats``), as a difference over
  the window.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import time

MZ_TIME_KEYS = ("pack", "dispatch", "device-sync", "d2h", "replay",
                "lane-wait", "lane-busy")


class Hooks:
    def __init__(self, yama_pack):
        self.P = yama_pack
        self.spans: dict = {"stream.submit": [], "stream.finish": []}
        self.launched: list = []  # the jobs of each device launch
        self.mz_time: dict = {k: 0.0 for k in MZ_TIME_KEYS}
        self.routes: dict = {}

    def __enter__(self):
        P = self.P
        cls = P.PackedDPStream
        self._saved = (cls.submit, cls.finish, P.pack_wire,
                       os.environ.get("MZ_TIME"))
        submit, finish, pack_wire = self._saved[:3]
        sub, fin = self.spans["stream.submit"], self.spans["stream.finish"]
        launched = self.launched

        def t_submit(stream, job):
            t0 = time.perf_counter()
            try:
                return submit(stream, job)
            finally:
                sub.append((t0, time.perf_counter()))

        def t_finish(stream):
            t0 = time.perf_counter()
            try:
                return finish(stream)
            finally:
                fin.append((t0, time.perf_counter()))

        def t_pack_wire(jobs, *a, **k):
            launched.append(list(jobs))
            return pack_wire(jobs, *a, **k)

        cls.submit, cls.finish, P.pack_wire = t_submit, t_finish, t_pack_wire
        os.environ["MZ_TIME"] = "1"
        self._routes0 = dict(P.route_stats)
        self._out = io.StringIO()
        self._redirect = contextlib.redirect_stdout(self._out)
        self._redirect.__enter__()
        return self

    def __exit__(self, *exc):
        self._redirect.__exit__(*exc)
        P = self.P
        cls = P.PackedDPStream
        cls.submit, cls.finish, P.pack_wire, mz = self._saved
        if mz is None:
            os.environ.pop("MZ_TIME", None)
        else:
            os.environ["MZ_TIME"] = mz
        self.routes = {k: v - self._routes0.get(k, 0)
                       for k, v in P.route_stats.items()}
        self._parse(self._out.getvalue())
        return False

    def _parse(self, text: str) -> None:
        for line in text.splitlines():
            if not line.startswith("[MZ_TIME]"):
                continue
            for key, val in re.findall(r"([\w-]+)=([-0-9.eE]+)\b", line):
                if key in self.mz_time:
                    self.mz_time[key] += float(val)

    def span_s(self, name: str) -> float:
        return sum(e - s for s, e in self.spans.get(name, ()))


def stream_us_per_job(run):
    """The stream's host stages (``MZ_TIME`` pack + dispatch + replay)
    over the jobs it sent to the card, in microseconds; None where no
    job reached the card."""
    if run.hooks is None:
        return None
    jobs = run.hooks.routes.get("device_jobs", 0)
    if not jobs:
        return None
    t = run.hooks.mz_time
    return (t["pack"] + t["dispatch"] + t["replay"]) / jobs * 1e6
