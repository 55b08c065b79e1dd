"""roast E=human over 8 placental mammals on their tree (the benchmark's
``ucsc_8sp_roast`` configuration, its region cut to 6 kb) on the CPU.
A roast reads only the 7 pairwise alignments with human first, as the
UCSC conservation tracks' autoMZ does. On the tree
``((((human chimp) macaque) ((mouse rat) rabbit)) (cow dog))`` one node
is the reference-leaf shortcut ``(human chimp)``, three call multiz with
v = 1 and three, the clades without human, with v = 0: the only calls
that plan pre_yama's v == 0 jobs and make a second DP round.

* The port's ``roast_run`` at the CPU's routing renders, byte for byte,
  the MAF of the benchmark's reference (``mzbench/reference/roast.py``:
  the frozen roast with a plain-PyTorch DP) and of the JAX package's
  ``roast_run``, on three seeds.
* With ``MZ_TIME`` set, a roast records a ``roast.merge`` span a node,
  the v == 0 counters and the second round's spans; a tba on the same
  region records none of them.
"""

import collections
import json
import os

import pytest

from multiz_tpu import scores as jsc
from multiz_tpu.maf import format_ali as jformat
from multiz_tpu.tree import roast_run as jroast
from multiz_tpu_torch import maf, scores, trace
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.tree import roast_run, tba_run
from mzbench import harness
from mzbench.reference import roast as reference
from mzbench.traffic import tba_tree_region

CONF = json.load(open(os.path.join(harness.HERE, "configs",
                                   "ucsc_8sp_roast.json")))
REF = CONF["roast"]["reference"]
SEEDS = (2**40 + 23, 7, 2**31 + 101)
V0 = {"preyama.plan.v0", "preyama.fold.v0"}


@pytest.fixture(scope="module", params=SEEDS)
def region(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("roast")
    return tba_tree_region.make(CONF, 6000, request.param, 1, str(d))


@pytest.fixture(autouse=True)
def _fresh_trace(monkeypatch):
    monkeypatch.delenv("MZ_TIME", raising=False)
    monkeypatch.setattr(trace, "on", False)  # restored after the test
    trace.reset()
    yield
    trace.reset()


def cfg():
    return MultizConfig(batch_fn=P.batch_fn_for("cpu"))


def port_maf(ds) -> str:
    blocks = roast_run(REF, ds["tree"], reference.ref_pairs(ds, REF),
                       src_dir=ds["src_dir"], cfg=cfg(),
                       sp=scores.init_scores70())
    return "".join(maf.format_ali(a) for a in blocks)


def test_a_roast_reads_the_seven_human_pairs(region):
    pairs = reference.ref_pairs(region, REF)
    assert region["tree"] == CONF["tree"]
    assert sorted(pairs) == sorted(f"{REF}.{s}.sing.maf"
                                   for s in CONF["species"] if s != REF)


def test_port_renders_the_reference_maf(region):
    got = port_maf(region)
    assert got.startswith("a score=")
    assert got == reference.maf(region, ref=REF)


def test_port_matches_the_jax_package(region):
    blocks = jroast(REF, region["tree"], reference.ref_pairs(region, REF),
                    src_dir=region["src_dir"], sp=jsc.init_scores70())
    assert port_maf(region) == "".join(jformat(a) for a in blocks)


def test_a_roast_records_its_nodes_and_second_rounds(region, monkeypatch):
    off = port_maf(region)
    monkeypatch.setenv("MZ_TIME", "1")
    assert port_maf(region) == off
    recs = trace.spans()
    (root,) = [i for i, s in enumerate(recs) if s.parent < 0]
    assert recs[root].name == "roast"
    merges = [s for s in recs if s.name == "roast.merge"]
    assert all(s.parent == root for s in merges)
    assert collections.Counter(s.attrs["v"] for s in merges) == {
        "ref-leaf": 1, 0: 3, 1: 3}
    sides = {s.attrs["nid"]: (s.attrs["v"], s.attrs["left"],
                              s.attrs["right"]) for s in merges}
    assert sides[0] == ("ref-leaf", ("human",), ("chimp",))
    assert (0, ("mouse",), ("rat",)) in sides.values()
    rounds = [s for s in recs if s.name == "multiz.dp.round2"]
    assert rounds and all(s.attrs["round"] == 2 for s in rounds)
    assert all(s.attrs["jobs"] > 0 and s.attrs["cells"] > 0 for s in rounds)
    assert all(recs[s.parent].name == "multiz.dp" for s in rounds)
    # a v == 0 job that reaches the DP is folded twice, once a round
    c = trace.counters()
    assert c["preyama.plan.v0"].count >= sum(s.attrs["jobs"] for s in rounds)
    assert c["preyama.fold.v0"].count == 2 * sum(s.attrs["jobs"]
                                                 for s in rounds)


def test_a_tba_on_the_region_records_none_of_them(region, monkeypatch):
    monkeypatch.setenv("MZ_TIME", "1")
    tba_run(region["tree"], list(region["pairs"]), src_dir=region["src_dir"],
            cfg=cfg(), sp=scores.init_scores70())
    names = {s.name for s in trace.spans()}
    assert "tba.merge" in names
    assert not names & {"roast", "roast.merge", "multiz.dp.round2"}
    assert not set(trace.counters()) & V0
