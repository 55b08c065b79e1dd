"""tba over all 28 pairwise alignments of 8 placental mammals on their
tree (the benchmark's ``encode_8sp_allpairs`` configuration, its region
cut to 6 kb) on the CPU. The tree
``((((human chimp) macaque) ((mouse rat) rabbit)) (cow dog))`` makes 21
bridges in tba.c's multi x multi branch, 4 in its multi x leaf branch
(the second at each node through get_covered) and 3 leaf + leaf merges,
branches no golden of the C toolkit reaches.

* The port's ``tba_run`` at the CPU's routing renders, byte for byte,
  the MAF of the benchmark's reference (``mzbench/reference/tba.py``:
  the frozen host modules with a plain-PyTorch DP) and of the JAX
  package's ``tba_run``.
* With ``MZ_TIME`` set, the bridge counters read 21, 4 and 3 a tba, and
  the ``tba.merge`` spans name their branch.
"""

import collections
import json
import os

import pytest

from multiz_tpu import scores as jsc
from multiz_tpu.maf import format_ali as jformat
from multiz_tpu.tree import tba_run as jtba
from multiz_tpu_torch import maf, scores, trace
from multiz_tpu_torch.multiz import MultizConfig
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.tree import tba_run
from mzbench import harness
from mzbench.reference import tba as reference
from mzbench.traffic import tba_tree_region

CONF = json.load(open(os.path.join(harness.HERE, "configs",
                                   "encode_8sp_allpairs.json")))


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    d = tmp_path_factory.mktemp("allpairs")
    return tba_tree_region.make(CONF, 6000, 2**40 + 11, 1, str(d))


@pytest.fixture(autouse=True)
def _fresh_trace(monkeypatch):
    monkeypatch.delenv("MZ_TIME", raising=False)
    monkeypatch.setattr(trace, "on", False)  # restored after the test
    trace.reset()
    yield
    trace.reset()


def port_maf(ds) -> str:
    blocks = tba_run(ds["tree"], list(ds["pairs"]), src_dir=ds["src_dir"],
                     cfg=MultizConfig(batch_fn=P.batch_fn_for("cpu")),
                     sp=scores.init_scores70())
    return "".join(maf.format_ali(a) for a in blocks)


def test_the_region_has_all_28_pairs(region):
    assert region["tree"] == CONF["tree"]
    assert len(region["pairs"]) == len(set(region["pairs"])) == 28


def test_port_renders_the_reference_maf(region):
    got = port_maf(region)
    assert got.startswith("a score=")
    assert got == reference.maf(region)


def test_port_matches_the_jax_package(region):
    blocks = jtba(region["tree"], list(region["pairs"]),
                  src_dir=region["src_dir"], sp=jsc.init_scores70())
    assert port_maf(region) == "".join(jformat(a) for a in blocks)


def test_every_branch_of_the_merge_runs(region, monkeypatch):
    monkeypatch.setenv("MZ_TIME", "1")
    for _ in range(2):
        port_maf(region)
    c = trace.counters()
    per_tba = {k: c[k].count / 2 for k in c if k.startswith("tba.bridge.")}
    assert per_tba == {"tba.bridge.mm": 21, "tba.bridge.ml": 4,
                       "tba.bridge.ll": 3}
    assert all(c[k].seconds > 0 for k in per_tba)
    kinds = collections.Counter(s.attrs["kind"] for s in trace.spans()
                                if s.name == "tba.merge")
    assert kinds == {"ll": 6, "ml": 4, "mm": 4}
