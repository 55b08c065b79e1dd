"""Traffic kind ``tba_region``: one simulated region, aligned by tba.

Makes the region the configuration describes from the seed: a reference
genome ("human") and one diverged genome per further species, each with
its pairwise MAF against the reference (substitutions, indels,
duplications on both sides, both strands; ``frozen/sim.py``), then
single coverage on each pair, as ``single_cov2`` writes it
(``multiz_tpu_torch/cli/single_cov2.py`` at 1de2067: both orientations,
sorted, dash-only rows removed, each block rescored). The guide tree is
the caterpillar ``((human s1) s2) ...`` of
``multiz_tpu_torch/tools/fasta_pipeline.tree_of``.

Everything here is numpy and the frozen host modules: the program gets
only the files.
"""

from __future__ import annotations

import os

import numpy as np

from ..frozen import scores as sc
from ..frozen.blocks import flip_comps, row_dash_rm, sort_by_top_start
from ..frozen.maf import format_ali, read_maf
from ..frozen.sim import SimConfig, simulate
from ..frozen.single_cov import iterative_single_cov

REF = "human"


def rng_seed(seed: int, salt: int) -> np.random.SeedSequence:
    """A numpy seed from any whole number (negative or past 64 bits)."""
    return np.random.SeedSequence([seed % (1 << 64), salt])


def tree_of(species) -> str:
    tree = REF
    for s in species:
        tree = f"({tree} {s})"
    return tree


def single_cov2(src: str, dst: str, sp) -> None:
    """``single_cov2 src > dst`` (no R= and no F= option)."""
    alis = read_maf(src)
    alis = iterative_single_cov(alis, sp=sp)
    flip_comps(alis)
    alis = iterative_single_cov(alis, sp=sp)
    flip_comps(alis)
    with open(dst, "w") as fh:
        fh.write("##maf version=1 scoring=single_cov2\n")
        for a in sort_by_top_start(alis):
            a = row_dash_rm(a)
            if a is None or len(a.comps) < 2:
                continue
            a.score = sc.score_range(a, 0, a.text_size, sp=sp)
            fh.write(format_ali(a))
        fh.write("##eof maf\n")


def make(config: dict, bases: int, seed: int, salt: int, d: str) -> dict:
    """The dataset of one region of ``bases`` reference bases in
    directory ``d``: {"tree", "pairs", "src_dir", "ref_bases"}."""
    species = tuple(config["species"])
    divergence = tuple(config["divergence"])
    # SimConfig takes an int seed; draw it from the whole-number seed
    sim_seed = int(np.random.default_rng(rng_seed(seed, salt)).integers(1 << 62))
    cfg = SimConfig(seed=sim_seed, ref_len=bases, species=species,
                    divergence=divergence, **config.get("sim", {}))
    simulate(cfg, d)
    sp = sc.init_scores70()
    pairs = []
    for s in species:
        pair = f"{REF}.{s}.sing.maf"
        single_cov2(os.path.join(d, f"{REF}.{s}.orig.maf"),
                    os.path.join(d, pair), sp)
        os.remove(os.path.join(d, f"{REF}.{s}.orig.maf"))
        pairs.append(pair)
    return {"tree": tree_of(species), "pairs": pairs, "src_dir": d,
            "ref_bases": bases}
