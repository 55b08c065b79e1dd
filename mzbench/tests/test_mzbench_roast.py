"""The roast cell ``ucsc_8sp_roast.roast_500kb``: its configuration, its
reference against the C toolkit, whole runs of it on the CPU at a small
region (sound, under the control, with a fault planted), and the readers
of its per-layer metrics on synthetic spans."""

import io
import json
import os
from types import SimpleNamespace

import pytest

from mzbench import harness, progtrace
from mzbench.control import CONTROL
from mzbench.frozen import scores as fsc
from mzbench.frozen import multiz as fmz
from mzbench.frozen.maf import format_ali, read_maf
from mzbench.frozen.roast import roast_run
from mzbench.harness import Op, Run
from mzbench.reference import dp as rdp
from mzbench.reference import roast as rroast
from multiz_tpu_torch import trace as T

CELL = "ucsc_8sp_roast.roast_500kb"
GOLDEN = os.path.join(harness.ROOT, "tests", "golden")
# (data, tree, species, the C toolkit's roast E=human output)
GOLDENS = {
    "roast4": ("data", "(((human chimp) mouse) rat)",
               ("chimp", "mouse", "rat")),
    "roast5": ("data5", "((((human chimp) mouse) rat) dog)",
               ("chimp", "mouse", "rat", "dog")),
}


def block_lines(text):
    return [ln for ln in text.split("\n") if ln and ln[0] != "#"]


def load(path):
    with open(os.path.join(harness.ROOT, path)) as fh:
        return json.load(fh)


def test_configuration_shares_the_all_pairs_genomes():
    """Species, tree and evolution are ``encode_8sp_allpairs``'s, value
    for value, so a seed makes the same genomes in both cells."""
    mine = load("mzbench/configs/ucsc_8sp_roast.json")
    theirs = load("mzbench/configs/encode_8sp_allpairs.json")
    for key in ("species", "tree", "assumed"):
        assert mine[key] == theirs[key], key
    assert mine["roast"]["reference"] in mine["species"]
    files = harness.cell_files(CELL)
    assert files["mix"]["kind"] == "tba_tree_region"
    assert files["mix"]["entry"] == "roast_tree"


@pytest.mark.parametrize("name", sorted(GOLDENS))
@pytest.mark.parametrize("dp", ["numpy", "reference"])
def test_frozen_roast_renders_the_c_toolkits_output(name, dp):
    """The frozen roast with the frozen numpy DP, and the reference (the
    frozen roast with the plain-PyTorch DP in the batch slot), against
    the C toolkit's roast (block lines; '#' lines are provenance)."""
    data, tree, species = GOLDENS[name]
    ds = {"tree": tree, "src_dir": os.path.join(GOLDEN, data),
          "pairs": [f"human.{s}.sing.maf" for s in species]}
    if dp == "numpy":
        blocks = roast_run("human", tree, ds["pairs"], src_dir=ds["src_dir"],
                           sp=fsc.init_scores70())
        got = "".join(format_ali(a) for a in blocks)
    else:
        got = rroast.maf(ds)
    with open(os.path.join(GOLDEN, "expect", name + ".maf")) as fh:
        want = block_lines(fh.read())
    assert len(want) > 30
    assert block_lines(got) == want


def test_frozen_multiz_v0_renders_the_c_toolkits_output():
    """The v == 0 plan and its second DP round, which the roast goldens
    never reach (human is in every clade of their trees, so every call
    is v = 1): the frozen multiz at v = 0 with the reference DP in the
    batch slot, as the reference roast runs it, against the C toolkit's
    ``multiz human.chimp.sing.maf human.mouse.sing.maf 0`` (block
    lines)."""
    src = os.path.join(GOLDEN, "data")
    sp = fsc.init_scores70()
    rounds = []

    def batch_fn(jobs, sp=None):
        rounds.append(len(jobs))
        return rdp.yama_batch(jobs, sp)

    out = io.StringIO()
    fmz.multiz(read_maf(os.path.join(src, "human.chimp.sing.maf")),
               read_maf(os.path.join(src, "human.mouse.sing.maf")), 0, out,
               cfg=fmz.MultizConfig(batch_fn=batch_fn), sp=sp)
    with open(os.path.join(GOLDEN, "expect", "multiz_v0.maf")) as fh:
        want = block_lines(fh.read())
    assert len(want) > 30
    assert block_lines(out.getvalue()) == want
    assert len(rounds) == 2 and min(rounds) > 0  # both DP rounds ran


def tiny():
    files = harness.cell_files(CELL)
    files["mix"].update(region_bases=6000)
    return files


def run(**kw):
    return harness.run_cell(CELL, 2**32 + 29, 0.3, False, "cpu",
                            files=tiny(), **kw)


@pytest.fixture
def device_path(monkeypatch):
    from multiz_tpu_torch.ops import yama_pack

    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    yama_pack.reset_route_stats()
    return yama_pack


def test_sound_run_is_correct(device_path):
    line = run()
    assert line["correct"], line
    assert line["checks"]["maf_blocks_differing"]["value"] == 0
    assert device_path.route_stats["device_jobs"] > 0
    assert set(line["metrics"]) == {"tba_refbases_per_s", "setup_s"}


def test_control_is_not_correct():
    line = run(control=CONTROL)
    assert not line["correct"]
    assert line["failed"] == 0
    assert line["checks"]["maf_blocks_differing"]["value"] > 0


def test_an_altered_answer_is_not_correct(device_path, monkeypatch):
    """One answer of each launch altered once set-up is done, so that the
    window meets it."""
    from mzbench.entries import roast_tree

    P = device_path
    setup, replay = roast_tree.Entry.setup, P._replay_payload_slots

    def bad(out_np, slots, jobs, results):
        replay(out_np, slots, jobs, results)
        r = results[slots[0]]
        r[0, 0] = ord("T") if r[0, 0] != ord("T") else ord("G")

    def setup_then_break(self):
        setup(self)
        monkeypatch.setattr(P, "_replay_payload_slots", bad)

    monkeypatch.setattr(roast_tree.Entry, "setup", setup_then_break)
    line = run()
    assert not line["correct"], line
    assert line["failed"] > 0 or (
        line["checks"]["maf_blocks_differing"]["value"] > 0)


# --- the readers of the per-layer metrics ------------------------------

# read spans and counters that the program records only since the cell
NEW_NAMES = ("roast_tree_s_per_roast", "preyama_v0_s_per_roast",
             "dp_round2_s_per_roast")
READERS = NEW_NAMES + ("maf_read_s_per_roast", "project_s_per_roast",
                       "merge_scan_s_per_roast", "preyama_s_per_roast",
                       "maf_render_s_per_roast")


def span(name, t0, t1, parent, run, charged=0.0):
    s = T.Span(name, t0, parent, run, None)
    s.t1, s.charged = t1, charged
    return s


# two roasts in the window (10, 20), one before it
SPANS = [
    span("roast", 10.0, 14.0, -1, 1),
    span("roast.merge", 10.5, 11.5, 0, 1, charged=0.2),
    span("roast.merge", 11.5, 13.5, 0, 1),
    span("multiz", 11.6, 13.4, 2, 1),
    span("multiz.dp", 12.0, 13.0, 3, 1, charged=0.1),
    span("multiz.dp.round2", 12.2, 12.7, 4, 1),
    span("stream.finish", 12.3, 12.6, 5, 1),
    span("roast", 15.0, 19.0, -1, 2),
    span("roast.merge", 15.0, 18.0, 7, 2),
    span("multiz.dp.round2", 16.0, 16.25, 8, 2),
    span("roast", 9.0, 9.5, -1, 3),
    span("multiz.dp.round2", 9.1, 9.2, 10, 3),
    span("maf.read", 10.6, 10.8, 1, 1),
    span("maf_project", 11.0, 11.4, 1, 1),
    span("multiz.scan", 11.7, 11.9, 3, 1),
    span("maf.read", 15.1, 15.4, 8, 2),
    span("maf.read", 9.2, 9.3, 10, 3),
]
COUNTERS = {
    "preyama.plan.v0": T.Counter("preyama.plan.v0", 10, 0.25),
    "preyama.fold.v0": T.Counter("preyama.fold.v0", 20, 0.35),
    "preyama.plan": T.Counter("preyama.plan", 10, 5.0),
    "maf.format": T.Counter("maf.format", 4, 0.3),
}


def program(spans, counters):
    return SimpleNamespace(spans=lambda: list(spans), self_times=T.self_times,
                           counters=lambda: dict(counters))


def a_run(hooks=True):
    return Run(name=CELL, window=(10.0, 20.0),
               ops=[Op(10.0, 15.0, 1, True), Op(15.0, 19.5, 1, True)],
               hooks=SimpleNamespace() if hooks else None)


@pytest.mark.parametrize("name,want", [
    # the roasts' self times 4 - 1 - 2 and 4 - 3, the merges' 1 - 0.2 -
    # 0.2 - 0.4, 2 - 1.8 and 3 - 0.25 - 0.3
    ("roast_tree_s_per_roast", (1.0 + 1.0 + 0.2 + 0.2 + 2.45) / 2),
    ("preyama_v0_s_per_roast", (0.25 + 0.35) / 2),
    ("dp_round2_s_per_roast", (0.5 + 0.25) / 2),  # whole durations
    ("maf_read_s_per_roast", (0.2 + 0.3) / 2),  # not the one before 10
    ("project_s_per_roast", 0.4 / 2),
    # multiz 1.8 - 1.0 - 0.2, multiz.dp 1.0 - 0.5 - 0.1, multiz.scan 0.2
    ("merge_scan_s_per_roast", (0.6 + 0.4 + 0.2) / 2),
    ("preyama_s_per_roast", 5.0 / 2),
    ("maf_render_s_per_roast", 0.3 / 2),
])
def test_readers_give_the_seconds_per_roast(name, want, monkeypatch):
    monkeypatch.setattr(progtrace, "program_trace",
                        lambda: program(SPANS, COUNTERS))
    assert harness.metric_reader(name)(a_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_where_there_is_nothing(name, monkeypatch):
    read = harness.metric_reader(name)
    monkeypatch.setattr(progtrace, "program_trace",
                        lambda: program(SPANS, COUNTERS))
    assert read(a_run(hooks=False)) is None  # an untraced run
    monkeypatch.setattr(progtrace, "program_trace", lambda: None)
    assert read(a_run()) is None  # a program with no trace module
    if name in NEW_NAMES:
        # a program from before the roast's spans and counters: its
        # roasts have a root span and nothing else
        old = [s for s in SPANS if s.name in ("roast", "stream.finish")]
        monkeypatch.setattr(progtrace, "program_trace", lambda: program(
            [span(s.name, s.t0, s.t1, -1, s.run) for s in old],
            {"preyama.plan": COUNTERS["preyama.plan"]}))
        assert read(a_run()) is None
    # no roast in the window
    monkeypatch.setattr(progtrace, "program_trace", lambda: program(
        [span("roast", 9.0, 9.5, -1, 3),
         span("multiz.dp.round2", 9.1, 9.2, 0, 3)], COUNTERS))
    assert read(a_run()) is None
