"""The traffic kind ``tba_tree_region`` (8 species x 6 kb of the
configuration ``encode_8sp_allpairs``): every row of the 28 pairwise MAFs
is its species' one genome at the row's coordinates and strand, each
pair file is named as tba looks it up, identity falls with distance on
the tree, and the region repeats per seed."""

import filecmp
import json
import os

import numpy as np
import pytest

from mzbench import harness
from mzbench.frozen.maf import read_maf
from mzbench.frozen.seqio import read_fasta
from mzbench.frozen.sim import DASH, revcomp
from mzbench.frozen.tree import parse_species_tree
from mzbench.traffic import tba_tree_region as G

CONF = json.load(open(os.path.join(harness.HERE, "configs",
                                   "encode_8sp_allpairs.json")))
BASES = 6000


def region(tmp_path, seed, name="r"):
    d = tmp_path / name
    d.mkdir()
    return G.make(CONF, BASES, seed, 1, str(d))


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    ds = region(tmp_path_factory.mktemp("tree"), 2**41 + 3)
    genomes = {}
    for s in CONF["species"]:
        (contig,) = read_fasta(os.path.join(ds["src_dir"], s))
        genomes[s] = np.asarray(contig.seq, np.uint8)
    pairs = {p: read_maf(os.path.join(ds["src_dir"], p)) for p in ds["pairs"]}
    return ds, genomes, pairs


def test_the_newick_gives_the_tree_and_species():
    root = G.parse_newick(CONF["assumed"]["branch_lengths"])
    assert root.tba_tree() == CONF["tree"]
    assert root.leaves() == CONF["species"]


def test_every_row_is_its_genome_at_its_coordinates(made):
    ds, genomes, pairs = made
    assert len(genomes[G.REF]) == BASES
    rows = 0
    for name, alis in pairs.items():
        x, y = name.split(".")[:2]
        assert alis
        for a in alis:
            assert [c.src for c in a.comps] == [f"{x}.chr1", f"{y}.chr1"]
            assert a.comps[0].strand == "+"
            for c in a.comps:
                g = genomes[c.src.split(".")[0]]
                assert c.src_size == len(g)
                bases = c.text[c.text != DASH]
                lo = c.start if c.strand == "+" else len(g) - c.start - c.size
                seg = g[lo:lo + c.size]
                assert bases.size == c.size
                assert np.array_equal(
                    bases, seg if c.strand == "+" else revcomp(seg))
                rows += 1
    assert rows > 2 * 28 * 5


def test_each_genome_is_in_its_seven_pairs(made):
    ds, genomes, pairs = made
    for s in CONF["species"]:
        mine = [p for p in pairs if s in p.split(".")[:2]]
        assert len(mine) == 7
        sizes = {c.src_size for p in mine for a in pairs[p] for c in a.comps
                 if c.src.startswith(s + ".")}
        assert sizes == {len(genomes[s])}


def test_pairs_are_named_as_tba_looks_them_up(made):
    ds = made[0]
    wanted = []

    def bridge(x, y, nid):
        wanted.extend(f"{a}.{b}.sing.maf" for a in x.names for b in y.names)

    parse_species_tree(ds["tree"], bridge)
    assert sorted(wanted) == sorted(ds["pairs"])


def identity(alis):
    same = both = 0
    for a in alis:
        x, y = (c.text for c in a.comps)
        m = (x != DASH) & (y != DASH)
        same += int(((x == y) & m).sum())
        both += int(m.sum())
    return same / both


def test_sisters_are_closer_than_distant_pairs(made):
    pairs = made[2]
    ident = {p.rsplit(".sing.maf")[0]: identity(a) for p, a in pairs.items()}
    for near in ("human.chimp", "mouse.rat"):
        for far in ("human.dog", "rabbit.cow"):
            assert ident[near] > ident[far] + 0.05, (near, far, ident)
    assert ident["human.chimp"] > ident["human.macaque"] > ident["human.mouse"]


@pytest.mark.parametrize("seed", [0, 2**31 + 5, -12])
def test_region_repeats_per_seed(tmp_path, seed):
    a = region(tmp_path, seed, "a")
    b = region(tmp_path, seed, "b")
    names = sorted(os.listdir(a["src_dir"]))
    assert len(names) == 8 + 28  # FASTAs, pairs
    _, mismatch, errors = filecmp.cmpfiles(a["src_dir"], b["src_dir"],
                                           names, shallow=False)
    assert not mismatch and not errors


def test_region_differs_across_seeds(tmp_path):
    a = region(tmp_path, 1, "a")
    b = region(tmp_path, 2, "b")
    assert not filecmp.cmp(os.path.join(a["src_dir"], "human.dog.sing.maf"),
                           os.path.join(b["src_dir"], "human.dog.sing.maf"),
                           shallow=False)
