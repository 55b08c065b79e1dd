"""The control of ``correct``: the reference, put in the program's place
and computed in the next precision below the configuration's int32
scores, must come out as not correct.

    python -m mzbench.control --workload CELL --seeds 1,2,3 --seconds S

runs the cell once per seed with the control standing in for the
program: the DP's values in int16 (``reference/dp.py``, MININT -2**14,
walks that leave their band finished along the diagonal). Each run's
numbers compared are printed beside their limits, one JSON line a seed.
The benchmark's own runs never run it. Needs a card, as the benchmark
does; ``--device cpu`` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness

CONTROL = {"dtype": torch.int16, "minint": -(2**14), "clamp": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mzbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("mzbench.control: torch sees no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in a.seeds.split(",")):
        line = harness.run_cell(a.workload, seed, a.seconds, False, a.device,
                                control=CONTROL)
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
