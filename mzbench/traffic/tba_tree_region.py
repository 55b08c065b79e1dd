"""Traffic kind ``tba_tree_region``: one simulated region over a species
tree, aligned by tba from every pair the tree joins.

Makes the region the configuration describes from the seed. Each
conserved block starts as a random root sequence and is evolved down the
tree of ``assumed.branch_lengths`` (substitutions, indels and an
inversion now and then on each branch, at the rates of
``assumed.evolution``), so that its true multiple alignment is known.
Each species has one genome: its copy of every block in the reference's
order, on the strand its inversions left it, with unaligned sequence
between blocks, and at its end the copies of the species' duplications
(a column slice of a block, on either strand, as ``frozen/sim.py``
makes them). The reference ("human") is laid first, with gaps between
blocks, and is exactly ``bases`` long.

Each pair ``x.y`` (``x`` before ``y`` in the tree's leaf order, the order
in which tba looks it up) gets the two rows of every block both hold,
dash-only columns removed, and the slice of each duplication of ``x`` or
``y`` against the other's original; the top row is put on the plus
strand, as a pairwise aligner writes it. Then single coverage on each
pair, as ``single_cov2`` writes it (``tba_region.single_cov2``).

Everything here is numpy and the frozen host modules: the program gets
only the files.
"""

from __future__ import annotations

import os

import numpy as np

from ..frozen import scores as sc
from ..frozen.maf import Ali, Comp, format_ali
from ..frozen.sim import ACGT, DASH, _fasta, revcomp
from .tba_region import REF, rng_seed, single_cov2

CONTIG = "chr1"


class Node:
    __slots__ = ("name", "length", "children")

    def __init__(self, name=None, length=0.0, children=()):
        self.name, self.length, self.children = name, length, list(children)

    def leaves(self) -> list:
        if not self.children:
            return [self.name]
        return [n for c in self.children for n in c.leaves()]

    def tba_tree(self) -> str:
        """The tree as tba takes it: ``((a b) c)``."""
        if not self.children:
            return self.name
        return "(" + " ".join(c.tba_tree() for c in self.children) + ")"


def parse_newick(s: str) -> Node:
    """A Newick tree with branch lengths, ``((a:0.1,b:0.2):0.3,c:0.4)``."""
    pos = 0

    def length() -> float:
        nonlocal pos
        if pos < len(s) and s[pos] == ":":
            j = pos + 1
            while j < len(s) and s[j] not in ",()":
                j += 1
            v, pos = float(s[pos + 1:j]), j
            return v
        return 0.0

    def node() -> Node:
        nonlocal pos
        if s[pos] == "(":
            kids = []
            while s[pos] in "(,":
                pos += 1
                kids.append(node())
            if s[pos] != ")":
                raise ValueError(f"newick: ')' expected at {pos}: {s}")
            pos += 1
            return Node(None, length(), kids)
        j = pos
        while j < len(s) and s[j] not in ":,()":
            j += 1
        name, pos = s[pos:j], j
        if not name:
            raise ValueError(f"newick: a name expected at {pos}: {s}")
        return Node(name, length())

    s = s.strip().rstrip(";").replace(" ", "")
    root = node()
    if pos != len(s):
        raise ValueError(f"newick: trailing text at {pos}: {s}")
    return root


def evolve_block(n: int, root: Node, ev: dict, rng):
    """One block of ``n`` root columns evolved down the tree: ({leaf:
    its row}, {leaf: its strand relative to the root, True for flipped}),
    the rows aligned, with dash-only columns removed."""
    rows = [ACGT[rng.integers(0, 4, n)]]
    flip = [False]
    at: dict = {}

    def branch(i: int, L: float) -> int:
        child = rows[i].copy()
        nd = np.flatnonzero(child != DASH)
        sub = rng.random(nd.size) < L
        child[nd[sub]] = ACGT[rng.integers(0, 4, int(sub.sum()))]
        ins_at, ins_len = [], []
        for _ in range(int(rng.poisson(ev["indel_per_site_per_unit"] * L
                                       * nd.size))):
            ln = 1 + int(rng.poisson(ev["mean_indel"]))
            if rng.random() < 0.5:  # a deletion, on this branch's copy
                j = int(rng.integers(0, nd.size))
                child[nd[j:j + ln]] = DASH
            else:  # an insertion: new columns, dashes in every other row
                ins_at.append(int(rng.integers(0, child.size + 1)))
                ins_len.append(ln)
        if ins_at:
            idx = np.repeat(ins_at, ins_len)
            rows[:] = [np.insert(r, idx, DASH) for r in rows]
            child = np.insert(child, idx, ACGT[rng.integers(0, 4, idx.size)])
        rows.append(child)
        p = min(0.5, ev["inversion_per_block_per_unit"] * L)
        flip.append(flip[i] ^ bool(rng.random() < p))
        return len(rows) - 1

    def visit(node: Node, i: int) -> None:
        if not node.children:
            at[node.name] = i
        for c in node.children:
            visit(c, branch(i, c.length))

    visit(root, 0)
    names = list(at)
    M = np.stack([rows[at[s]] for s in names])
    M = M[:, (M != DASH).any(axis=0)]
    return ({s: M[k] for k, s in enumerate(names)},
            {s: flip[at[s]] for s in names})


class Genome:
    """A species' sequence as it is laid out, block copy by block copy."""

    def __init__(self):
        self.parts: list = []
        self.size = 0

    def put(self, seq: np.ndarray) -> int:
        """Append ``seq``; returns where it starts."""
        start = self.size
        self.parts.append(seq)
        self.size += seq.size
        return start

    def filler(self, n: int, rng) -> None:
        if n > 0:
            self.put(ACGT[rng.integers(0, 4, n)])

    def seq(self) -> np.ndarray:
        return (np.concatenate(self.parts) if self.parts
                else np.zeros(0, np.uint8))


def place(g: Genome, row: np.ndarray, minus: bool):
    """Lay a row's bases into ``g`` on the strand ``minus`` says; the
    copy (its plus-strand start, its size, its strand), None if it has
    no base."""
    seq = row[row != DASH]
    if not seq.size:
        return None
    return (g.put(revcomp(seq) if minus else seq), int(seq.size),
            "-" if minus else "+")


def slice_of(copy, row: np.ndarray, c1: int, c2: int):
    """The copy of columns [c1, c2) of a row laid as ``copy``."""
    plus, size, strand = copy
    k1 = int(np.count_nonzero(row[:c1] != DASH))
    k = int(np.count_nonzero(row[c1:c2] != DASH))
    return (plus + k1 if strand == "+" else plus + size - k1 - k, k, strand)


def comp(name: str, copy, src_size: int, text: np.ndarray) -> Comp:
    plus, size, strand = copy
    start = plus if strand == "+" else src_size - plus - size
    return Comp(f"{name}.{CONTIG}", start, size, strand, src_size, text)


def pair_ali(x, tx, cx, y, ty, cy, sizes):
    """The block of rows ``x`` and ``y``, dash-only columns removed and
    the top row on the plus strand; None where a row has no base."""
    keep = (tx != DASH) | (ty != DASH)
    tx, ty = tx[keep], ty[keep]
    if not (tx != DASH).any() or not (ty != DASH).any():
        return None
    if cx[2] == "-":  # the same alignment read on the other strands
        tx, ty = revcomp(tx), revcomp(ty)
        cx = (cx[0], cx[1], "+")
        cy = (cy[0], cy[1], "+" if cy[2] == "-" else "-")
    return Ali(comps=[comp(x, cx, sizes[x], tx), comp(y, cy, sizes[y], ty)],
               score=sc.score_range_texts([tx, ty], 0, tx.size))


def write_pair(path: str, alis: list) -> None:
    with open(path, "w") as fh:
        fh.write("##maf version=1 scoring=blastz\n")
        fh.write("# simulated pairwise alignment\n")
        for a in sorted(alis, key=lambda a: a.comps[0].start):
            fh.write(format_ali(a))
        fh.write("##eof maf\n")


def make(config: dict, bases: int, seed: int, salt: int, d: str) -> dict:
    """The dataset of one region of ``bases`` reference bases in
    directory ``d``: {"tree", "pairs", "src_dir", "ref_bases"}."""
    root = parse_newick(config["assumed"]["branch_lengths"])
    ev = config["assumed"]["evolution"]
    species = root.leaves()
    if root.tba_tree() != config["tree"] or sorted(species) != sorted(
            config["species"]) or REF not in species:
        raise ValueError("branch_lengths do not give the configuration's "
                         "tree and species")
    rng = np.random.default_rng(rng_seed(seed, salt))
    sc.init_scores70()
    genomes = {s: Genome() for s in species}
    blocks = []  # (rows, {species: copy or None})
    ref = genomes[REF]
    ref.filler(int(rng.integers(0, ev["gap_max"])), rng)
    while ref.size < bases:
        n = int(rng.integers(ev["block_min"], ev["block_max"]))
        rows, flip = evolve_block(n, root, ev, rng)
        if ref.size + np.count_nonzero(rows[REF] != DASH) > bases:
            break
        copies = {}
        for s in species:
            if s != REF:
                genomes[s].filler(int(rng.integers(0, ev["gap_max"] // 2)),
                                  rng)
            copies[s] = place(genomes[s], rows[s], flip[s] != flip[REF])
        blocks.append((rows, copies))
        ref.filler(min(int(rng.integers(1, ev["gap_max"])), bases - ref.size),
                   rng)
    ref.filler(bases - ref.size, rng)
    dups = []  # (block, species, c1, c2, copy)
    for b, (rows, copies) in enumerate(blocks):
        w = rows[REF].size
        for s in species:
            if s == REF or rng.random() >= ev["dup_prob"] or w < 120:
                continue
            c1 = int(rng.integers(0, w // 3))
            c2 = int(rng.integers(2 * w // 3, w))
            if np.count_nonzero(rows[s][c1:c2] != DASH) < 10:
                continue
            minus = bool(rng.random() < ev["minus_prob"])
            dups.append((b, s, c1, c2, place(genomes[s], rows[s][c1:c2],
                                             minus)))
    sizes = {s: g.size for s, g in genomes.items()}
    for s, g in genomes.items():
        _fasta(os.path.join(d, s), s, CONTIG, g.seq())
    pairs = []
    for i, x in enumerate(species):
        for y in species[i + 1:]:
            alis = [pair_ali(x, rows[x], cp[x], y, rows[y], cp[y], sizes)
                    for rows, cp in blocks if cp[x] and cp[y]]
            for b, s, c1, c2, dup in dups:
                if s not in (x, y):
                    continue
                rows, cp = blocks[b]
                t = y if s == x else x
                if cp[t] is None:
                    continue
                ct = slice_of(cp[t], rows[t], c1, c2)
                if s == x:
                    alis.append(pair_ali(x, rows[x][c1:c2], dup, y,
                                         rows[y][c1:c2], ct, sizes))
                else:
                    alis.append(pair_ali(x, rows[x][c1:c2], ct, y,
                                         rows[y][c1:c2], dup, sizes))
            orig = os.path.join(d, f"{x}.{y}.orig.maf")
            write_pair(orig, [a for a in alis if a is not None])
            pair = f"{x}.{y}.sing.maf"
            single_cov2(orig, os.path.join(d, pair), sc.init_scores70())
            os.remove(orig)
            pairs.append(pair)
    return {"tree": config["tree"], "pairs": pairs, "src_dir": d,
            "ref_bases": bases}
