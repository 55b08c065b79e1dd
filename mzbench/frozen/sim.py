# Frozen copy of multiz_tpu_torch/tools/sim.py at commit 1de2067, kept by the benchmark
# (mzbench/) so that its inputs and its reference never import the program.
# Changes: the native runtime is never loaded (numpy only); cut to what
# the benchmark's sequential tba and inputs call.
"""Synthetic genome + pairwise-MAF simulator for golden tests and benches.

Generates a reference species ("human") and diverged species with
substitutions and indels, writing:
  * one FASTA per species (header format parseHeader understands,
    multi_util.c:311-322: ">name:chr:start-end:strand:size")
  * human.<sp>.orig.maf pairwise blocksets, sorted by reference start,
    including injected overlapping blocks (duplications) on both the
    reference and species sides so single-coverage filtering has work to do,
    and a mix of +/- strand blocks.

All block texts are consistent with the emitted FASTAs (required by tba's
must_equal cross-checks, mz_preyama.c:362-384).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
DASH = ord("-")
_COMPL = np.zeros(256, dtype=np.uint8)
for a, b in zip(b"ACGTacgtNn-", b"TGCAtgcaNn-"):
    _COMPL[a] = b


def revcomp(x: np.ndarray) -> np.ndarray:
    return _COMPL[x[::-1]]


@dataclass
class SimConfig:
    seed: int = 0
    ref_len: int = 20000
    species: tuple = ("chimp", "mouse", "rat")
    divergence: tuple = (0.02, 0.25, 0.30)
    indel_rate: float = 0.01
    mean_indel: float = 3.0
    block_min: int = 50
    block_max: int = 800
    gap_max: int = 300
    minus_prob: float = 0.3
    dup_prob: float = 0.12
    contig: str = "chr1"


@dataclass
class Block:
    ref_start: int
    ref_text: np.ndarray
    sp_text: np.ndarray
    strand: str
    sp_plus_start: int
    sp_len: int


def _fasta(path: str, name: str, contig: str, seq: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name}:{contig}:1-{len(seq)}:+:{len(seq)}\n")
        s = seq.tobytes().decode()
        for i in range(0, len(s), 60):
            fh.write(s[i : i + 60] + "\n")


def _mutate_block(ref_seg: np.ndarray, div: float, cfg: SimConfig, rng):
    """Return (ref_text, sp_text) alignment columns for one block."""
    n = len(ref_seg)
    rcols, scols = [], []
    i = 0
    while i < n:
        r = rng.random()
        if r < cfg.indel_rate / 2:  # insertion in species
            ln = 1 + int(rng.poisson(cfg.mean_indel))
            ins = ACGT[rng.integers(0, 4, ln)]
            rcols.append(np.full(ln, DASH, np.uint8))
            scols.append(ins)
        elif r < cfg.indel_rate:  # deletion in species
            ln = min(1 + int(rng.poisson(cfg.mean_indel)), n - i)
            rcols.append(ref_seg[i : i + ln])
            scols.append(np.full(ln, DASH, np.uint8))
            i += ln
        else:
            ln = min(int(rng.integers(10, 50)), n - i)
            seg = ref_seg[i : i + ln].copy()
            sub = rng.random(ln) < div
            seg[sub] = ACGT[rng.integers(0, 4, int(sub.sum()))]
            rcols.append(ref_seg[i : i + ln])
            scols.append(seg)
            i += ln
    return np.concatenate(rcols), np.concatenate(scols)


def _simulate_pair(ref: np.ndarray, div: float, cfg: SimConfig, rng):
    """Returns (blocks, species_genome)."""
    blocks: list[Block] = []
    genome: list[np.ndarray] = []
    glen = 0
    pos = int(rng.integers(0, cfg.gap_max))
    while pos < len(ref) - cfg.block_min:
        # unaligned species insert between blocks
        ins = int(rng.integers(0, cfg.gap_max // 2))
        if ins:
            genome.append(ACGT[rng.integers(0, 4, ins)])
            glen += ins
        n = int(rng.integers(cfg.block_min, cfg.block_max))
        n = min(n, len(ref) - pos)
        rt, st = _mutate_block(ref[pos : pos + n], div, cfg, rng)
        seg = st[st != DASH]
        strand = "-" if rng.random() < cfg.minus_prob else "+"
        stored = revcomp(seg) if strand == "-" else seg
        blocks.append(
            Block(pos, rt, st, strand, glen, len(seg))
        )
        genome.append(stored)
        glen += len(seg)
        pos += n + int(rng.integers(1, cfg.gap_max))

    # ---- duplication injection (consistent with the FASTA) ----
    base = list(blocks)
    for b in base:
        if rng.random() >= cfg.dup_prob or len(b.ref_text) < 120:
            continue
        if rng.random() < 0.5:
            # ref-side overlap: re-align a column slice of b to a fresh
            # species copy appended to the genome
            w = len(b.ref_text)
            c1 = int(rng.integers(0, w // 3))
            c2 = int(rng.integers(2 * w // 3, w))
            rt = b.ref_text[c1:c2]
            st = b.sp_text[c1:c2].copy()
            keep = (rt != DASH) | (st != DASH)
            rt, st = rt[keep], st[keep]
            if (rt != DASH).sum() < 10 or (st != DASH).sum() < 10:
                continue
            nd = int(np.count_nonzero(rt != DASH))
            before = int(np.count_nonzero(b.ref_text[:c1] != DASH))
            seg = st[st != DASH]
            strand = "-" if rng.random() < cfg.minus_prob else "+"
            stored = revcomp(seg) if strand == "-" else seg
            blocks.append(
                Block(b.ref_start + before, rt, st, strand, glen, len(seg))
            )
            genome.append(stored)
            glen += len(seg)
        else:
            # species-side overlap: align the same species segment (only
            # '+' blocks, full segment) to a fresh ref interval, gaplessly
            if b.strand != "+":
                continue
            m = b.sp_len
            lo = int(rng.integers(0, len(ref) - m))
            rt = ref[lo : lo + m]
            st_seq = None
            # recover the species plus-strand text of b
            st_seq_arr = b.sp_text[b.sp_text != DASH]
            st = st_seq_arr
            blocks.append(Block(lo, rt.copy(), st.copy(), "+",
                                b.sp_plus_start, m))
    genome_arr = (
        np.concatenate(genome) if genome else np.zeros(0, dtype=np.uint8)
    )
    return blocks, genome_arr


def _write_pair_maf(path, ref_name, sp_name, contig, blocks, ref_len, sp_len,
                    score_fn):
    from . import maf

    blocks = sorted(blocks, key=lambda b: b.ref_start)
    with open(path, "w") as fh:
        fh.write("##maf version=1 scoring=blastz\n")
        fh.write("# simulated pairwise alignment\n")
        for b in blocks:
            rsize = int(np.count_nonzero(b.ref_text != DASH))
            ssize = int(np.count_nonzero(b.sp_text != DASH))
            if rsize == 0 or ssize == 0:
                continue
            if b.strand == "+":
                sstart = b.sp_plus_start
            else:
                sstart = sp_len - (b.sp_plus_start + b.sp_len)
            ali = maf.Ali(
                comps=[
                    maf.Comp(f"{ref_name}.{contig}", b.ref_start, rsize, "+",
                             ref_len, b.ref_text.copy()),
                    maf.Comp(f"{sp_name}.{contig}", sstart, ssize, b.strand,
                             sp_len, b.sp_text.copy()),
                ],
                score=score_fn([b.ref_text, b.sp_text]),
            )
            fh.write(maf.format_ali(ali))
        fh.write("##eof maf\n")


def simulate(cfg: SimConfig, outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    ref = ACGT[rng.integers(0, 4, cfg.ref_len)]
    _fasta(os.path.join(outdir, "human"), "human", cfg.contig, ref)

    from . import scores as sc

    sc.init_scores70()

    def score_fn(texts):
        return sc.score_range_texts(texts, 0, len(texts[0]))

    for sp, div in zip(cfg.species, cfg.divergence):
        blocks, genome = _simulate_pair(ref, div, cfg, rng)
        _fasta(os.path.join(outdir, sp), sp, cfg.contig, genome)
        _write_pair_maf(
            os.path.join(outdir, f"human.{sp}.orig.maf"),
            "human", sp, cfg.contig, blocks, cfg.ref_len, len(genome),
            score_fn,
        )

