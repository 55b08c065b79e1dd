"""Per-chromosome tba pipeline sharding (BASELINE config 4 semantics).

The reference's whole-genome workflow IS per-chromosome: every tool
splits its work lists by reference contig (``seperate_cp_wk``,
multi_util.c:816-843; the per-chromosome outer loop of multiz,
multiz.c:267-275), and production TBA runs are driven one chromosome at
a time with per-chromosome sequence files (tba_howto's prescribed
layout). Here that same split becomes the multi-process / multi-host
distribution axis: the driver partitions the contig universe over N
workers, each worker runs the FULL in-memory tba pipeline over the
contigs it owns (reading only its slice of the pair MAFs and sequence
files), and the calling process gathers the shards' outputs in shard
order (shard i holds the contigs at positions i, i+N, i+2N, ... of the
sorted contig list; see ``make_shards``). On a pod, each worker is a
host and the gather is an all-gather of serialized blocks over DCN; on
one machine it is a process pool.

Equality contract (tested in tests/test_pipeline_shard.py): the
gathered blockset is block-multiset identical to the single-process
run, and byte-identical PER CONTIG after ``maf_project`` onto the
reference — the form every reference workflow consumes (README2
prescribes projecting tba output per species, and the reference's
per-chromosome practice emits one output file per chromosome). Raw
single-process tba interleaves contig groups according to each tree
node's internal concatenation order (tba.c:242-243); that cross-contig
interleaving is a non-semantic artifact not reconstructible from
sharded outputs without replaying the merges.

Sharding key: the CONTIG NAME of each block's top row (and of each
sequence-file contig). As in the reference's per-chromosome practice,
all species must use consistent per-chromosome naming for the split to
be meaningful (a shard must own a contig name across every species).
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence

from ..maf import Ali, format_ali, read_maf, write_maf


def discover_contigs(pair_files: Sequence[str], src_dir: str) -> List[str]:
    """Top-row contig names present in the pair MAFs, sorted."""
    names = set()
    for pf in pair_files:
        for a in read_maf(os.path.join(src_dir, pf), verbose=False):
            names.add(a.comps[0].contig)
    return sorted(names)


def make_shards(contigs: Sequence[str], nshards: int) -> List[List[str]]:
    """Round-robin partition of the (sorted) contig list."""
    shards: List[List[str]] = [[] for _ in range(nshards)]
    for i, c in enumerate(contigs):
        shards[i % nshards].append(c)
    return [s for s in shards if s]


def _split_fasta(src: str, dst: str, keep: set) -> None:
    """Write the contigs of FASTA ``src`` whose contig name is in
    ``keep`` to ``dst`` (the per-chromosome sequence layout the
    reference's workflow uses)."""
    from ..seqio import parse_header, read_fasta

    with open(dst, "w") as out:
        for contig in read_fasta(src):
            meta = parse_header(os.path.basename(src), contig)
            if meta.contig not in keep:
                continue
            out.write(contig.header + "\n")
            seq = contig.seq.tobytes().decode("latin-1")
            for i in range(0, len(seq), 60):
                out.write(seq[i : i + 60] + "\n")


def stage_shard(
    pair_files: Sequence[str],
    src_dir: str,
    species: Sequence[str],
    contigs: Sequence[str],
    dst_dir: str,
) -> None:
    """Materialize one shard's inputs: pair MAFs filtered by top-row
    contig, sequence files filtered by contig name."""
    keep = set(contigs)
    for pf in pair_files:
        blocks = [
            a
            for a in read_maf(os.path.join(src_dir, pf), verbose=False)
            if a.comps[0].contig in keep
        ]
        write_maf(os.path.join(dst_dir, pf), blocks)
    for s in species:
        p = os.path.join(src_dir, s)
        if os.path.exists(p):
            _split_fasta(p, os.path.join(dst_dir, s), keep)


def _species_of(tree: str) -> List[str]:
    out: List[str] = []
    tok = ""
    for ch in tree + " ":
        if ch.isalnum() or ch in "_.":
            tok += ch
        else:
            if tok:
                out.append(tok)
            tok = ""
    return out


# the MultizConfig fields that can change a worker's output bytes; the
# rest (dp_fn, batch_fn) choose how the DP runs, not what it returns
WORKER_CFG_FIELDS = ("radius", "min_output_wid", "row2", "lrg_break_wid",
                     "sml_break_wid")


def _worker_main(args) -> bytes:
    """Run the full tba pipeline over one shard; returns the rendered
    blocks (workers render to bytes so the gather payload is exactly
    the MAF text a multi-host all-gather would move over DCN)."""
    (tree, pair_files, shard_dir, suffix, ref, aligner, sp, cfg_fields) = args
    # workers never touch the device: the card belongs to the calling
    # process, and the shard DP runs inline on the host
    os.environ["MULTIZ_TPU_TORCH_DEVICE"] = "none"
    from .. import scores as sc
    from ..multiz import MultizConfig
    from ..tree import tba_run

    sc.current = sp  # the caller's scheme, as init_scores* would set it
    cfg = MultizConfig(**cfg_fields)
    blocks = tba_run(
        tree, list(pair_files), src_dir=shard_dir, cfg=cfg,
        suffix=suffix, ref=ref, sp=sp, aligner=aligner,
    )
    return "".join(format_ali(a) for a in blocks).encode()


def tba_run_sharded(
    tree: str,
    pair_files: Sequence[str],
    src_dir: str = ".",
    cfg=None,
    suffix: str = ".sing.maf",
    ref: Optional[str] = None,
    aligner: str = "multiz",
    nshards: int = 2,
    sp=None,
    work_dir: Optional[str] = None,
) -> List[Ali]:
    """tba over ``nshards`` worker processes, one contig subset each.

    Returns the gathered blocks, shard after shard (``make_shards``'s
    round-robin over the sorted contigs). See the module docstring for
    the equality contract vs the single-process ``tree.tba_run``.

    Every worker runs with the caller's ``sp`` (default: the current
    scheme) and ``cfg``'s output fields (``WORKER_CFG_FIELDS``). The
    workers run the DP inline on the host, as the JAX package's do:
    ``cfg.batch_fn`` is not forwarded (a backend cannot change the
    bytes), and a ``cfg.dp_fn`` other than the oracle raises
    ValueError, since a worker cannot take a custom callable. With one
    shard the run stays in this process with ``cfg`` as it is.
    """
    from .. import scores as sc
    from ..maf import parse_maf_bytes
    from ..multiz import MultizConfig
    from ..yama import yama_numpy

    if cfg is None:
        cfg = MultizConfig()
    contigs = discover_contigs(pair_files, src_dir)
    shards = make_shards(contigs, nshards)
    if len(shards) <= 1:
        from ..tree import tba_run

        return tba_run(tree, list(pair_files), src_dir=src_dir, cfg=cfg,
                       suffix=suffix, ref=ref, sp=sp, aligner=aligner)
    if cfg.dp_fn is not yama_numpy:
        raise ValueError("tba_run_sharded: workers run the oracle DP; a "
                         f"custom dp_fn ({cfg.dp_fn!r}) cannot be sent")
    sp = sc.current if sp is None else sp
    cfg_fields = {f: getattr(cfg, f) for f in WORKER_CFG_FIELDS}
    species = _species_of(tree)
    tmp = work_dir or tempfile.mkdtemp(prefix="mz_shards_")
    # On a pod the staging phase does not exist: the reference
    # workflow's inputs are already laid out per chromosome, and each
    # host reads only its own slice. Here it is a one-time
    # single-threaded cost of the proxy.
    tasks = []
    for i, shard in enumerate(shards):
        d = os.path.join(tmp, f"shard{i}")
        os.makedirs(d, exist_ok=True)
        stage_shard(pair_files, src_dir, species, shard, d)
        tasks.append(
            (tree, tuple(pair_files), d, suffix, ref, aligner, sp,
             cfg_fields)
        )
    # spawn: workers must not inherit the parent's CUDA state
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Pool(processes=len(tasks)) as pool:
        payloads = pool.map(_worker_main, tasks)
    out: List[Ali] = []
    for payload in payloads:
        out.extend(
            parse_maf_bytes(b"##maf version=1 scoring=multiz\n" + payload)
        )
    return out
