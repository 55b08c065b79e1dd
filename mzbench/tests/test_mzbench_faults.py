"""``correct`` separates sound runs from broken ones: a whole run of each
cell (set-up, window, check) on the CPU at a tiny size, skipping only the
look for a card, with the timed path sound, with the control in the
program's place, and with each fault a cell can have planted in the
program's DP stream (every job routed to its device path)."""

import numpy as np
import pytest

from mzbench import harness
from mzbench.control import CONTROL

CELLS = ("encode_5sp.tba_2mb", "encode_5sp.dp_batches")
# a cell whose files are here but which BENCHMARK.json does not list yet
PARKED = {"encode_5sp.dp_batches": {"name": "encode_5sp.dp_batches",
                                    "config": "encode_5sp",
                                    "traffic": "dp_batches", "chips": 1}}


def parked_files(cell):
    import json
    import os

    c = PARKED[cell]
    with open(os.path.join(harness.HERE, "configs",
                           c["config"] + ".json")) as fh:
        config = json.load(fh)
    with open(os.path.join(harness.HERE, "traffic",
                           c["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    return {"cell": c, "config": config, "mix": mix}


def tiny(cell):
    files = (parked_files(cell) if cell in PARKED
             else harness.cell_files(cell))
    if files["mix"]["entry"] == "tba":
        files["mix"].update(region_bases=12000)
    else:
        files["mix"].update(pool_jobs=40, call_cells=60000)
    return files


def run(cell, **kw):
    return harness.run_cell(cell, 2**32 + 17, 0.3, False, "cpu",
                            files=tiny(cell), **kw)


@pytest.fixture
def device_path(monkeypatch):
    from multiz_tpu_torch.ops import yama_pack

    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    return yama_pack


def alter_an_answer(P, monkeypatch):
    replay = P._replay_payload_slots

    def bad(out_np, slots, jobs, results):
        replay(out_np, slots, jobs, results)
        r = results[slots[0]]
        r[0, 0] = ord("T") if r[0, 0] != ord("T") else ord("G")

    monkeypatch.setattr(P, "_replay_payload_slots", bad)


def leave_out_half(P, monkeypatch):
    replay = P._replay_payload_slots

    def half(out_np, slots, jobs, results):
        out_np = out_np.copy()
        out_np[len(slots) // 2 :] = out_np[0]
        replay(out_np, slots, jobs, results)

    monkeypatch.setattr(P, "_replay_payload_slots", half)


def state_unchanged(P, monkeypatch):
    device_batch = P.device_batch

    def idle(*a):
        out = device_batch(*a)
        return out.zero_()

    monkeypatch.setattr(P, "device_batch", idle)


FAULTS = {"answer_altered": alter_an_answer, "half_left_out": leave_out_half,
          "state_unchanged": state_unchanged}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, device_path):
    device_path.reset_route_stats()
    line = run(cell)
    assert line["correct"], line
    assert device_path.route_stats["device_jobs"] > 0
    assert all(c["value"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    line = run(cell, control=CONTROL)
    assert not line["correct"]
    assert line["failed"] == 0
    assert all(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, device_path, monkeypatch):
    """Planted once set-up is done, so that the window meets it."""
    import importlib

    entry = importlib.import_module(
        "mzbench.entries." + tiny(cell)["mix"]["entry"]).Entry
    setup = entry.setup

    def setup_then_break(self):
        setup(self)
        FAULTS[fault](device_path, monkeypatch)

    monkeypatch.setattr(entry, "setup", setup_then_break)
    line = run(cell)
    assert not line["correct"], line
    bad = sum(c["value"] for c in line["checks"].values())
    assert line["failed"] > 0 or bad > 0


def test_the_result_line_keeps_its_contract(device_path):
    line = run("encode_5sp.tba_2mb")
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(line["metrics"]) == {"tba_refbases_per_s", "setup_s"}
    assert all(np.isfinite(m["value"]) for m in line["metrics"].values())
