# Frozen copy of multiz_tpu_torch/tree.py at commit 1de2067, kept by the benchmark
# (mzbench/) so that its inputs and its reference never import the program.
# Changes: the native runtime is never loaded (numpy only); cut to what
# the benchmark's sequential tba and inputs call.
"""Guide-tree parsing and the tba merge schedule, in memory.

The reference drives the progressive alignment by generating shell command
pipelines over /tmp files (speciesTree.c:16-113, tba.c:114-276,
auto_mz.c:52-118). Here every intermediate "file" is a Python list of Ali
blocks and every tool invocation is an in-process function call, preserving
the exact block-level dataflow (tool order, concatenation order, projection
side outputs) so the final block stream equals the reference's.

Comment/header lines of intermediate files are not modeled: the reference's
`grep -v eof` / `grep -v maf` concatenations make them leak into outputs in
pid-dependent ways, so equality is defined over block lines (every '#' line
is provenance, not data).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import scores as sc
from .blocks import flip_comps, separate_by_src
from .maf import Ali, read_maf
from .maf_project import project
from .multiz import MultizConfig, multiz
from .threading_tools import get_covered, get_maf_between


# --------------------------------------------------------------------------
# tree parsing (speciesTree.c:37-113)
# --------------------------------------------------------------------------


@dataclass
class TreeNode:
    names: List[str] = field(default_factory=list)
    id: int = -1
    type: object = 0  # 0 = completed node, '(' = open paren


def parse_species_tree(
    tree_str: str,
    operation: Callable[[TreeNode, TreeNode, int], None],
    on_internal: Optional[Callable[[TreeNode, TreeNode, int], None]] = None,
) -> Tuple[int, int]:
    """Shift-reduce parse; fires ``operation(left, right, id)`` per internal
    node bottom-up. Returns (final_top, last_id). ``on_internal`` runs
    before ``operation`` (the mv/cp file plumbing hook)."""
    stack: List[TreeNode] = []
    next_id = 0
    i = 0
    q = tree_str
    while i < len(q):
        ch = q[i]
        if ch == "(":
            stack.append(TreeNode(type="("))
        elif ch == ")":
            if len(stack) < 2 or stack[-1].type != 0 or stack[-2].type != "(":
                raise ValueError(f"parse error: {q[: i + 1]}")
            top = stack.pop()
            stack.pop()
            stack.append(top)
        elif ch.isalpha():
            j = i
            while j < len(q) and (q[j].isalnum() or q[j] in "_."):
                j += 1
            stack.append(TreeNode(names=[q[i:j]], id=-1, type=0))
            i = j - 1
        elif ch != " ":
            raise ValueError(f"improper character in tree spec: {ch}")
        while len(stack) >= 2 and stack[-1].type == 0 and stack[-2].type == 0:
            right = stack[-1]
            left = stack[-2]
            if on_internal is not None:
                on_internal(left, right, next_id)
            operation(left, right, next_id)
            left.names = left.names + right.names
            stack.pop()
            stack[-1] = left
            stack[-1].id = next_id
            next_id += 1
        i += 1
    if len(stack) != 1 or stack[0].type != 0:
        raise ValueError("tree specification is improper")
    return 0, next_id


# --------------------------------------------------------------------------
# in-memory tool wrappers.
#
# Ownership-transfer calling convention: every wrapper CONSUMES its block
# list arguments (the blocks may be mutated in place and aliased into the
# outputs) — mirroring the reference, where each tool invocation reads a
# file whose content is never read again after the next step overwrites it
# (tba.c:180-254 rewrites each temp file per bridge iteration). Callers in
# this module always pass lists that are dead after the call; external
# callers who need their input preserved must pass ``_cp(alis)``.
# --------------------------------------------------------------------------

Blocks = List[Ali]


def _cp(alis: Blocks) -> Blocks:
    # fresh Ali/Comp objects sharing text buffers: tools mutate block
    # structure (row order, start/strand fields) and REPLACE texts, but
    # never write into a text array, so sharing is safe and saves the
    # dominant memcpy of the reference's re-parse-per-tool dataflow
    return [a.copy_shared() for a in alis]


def t_project(alis: Blocks, target: str, with_others: bool,
              sp=None) -> Tuple[Blocks, Blocks]:
    """maf_project invocation; ``with_others`` = an other-mafs file was
    given (which disables beautify, maf_project.c:703-704). Consumes
    ``alis``."""
    proj, others = project(
        alis, target, do_beautify=not with_others, sp=sp
    )
    return proj, others


def t_multiz(l1: Blocks, l2: Blocks, v: int, cfg: MultizConfig,
             sp=None) -> Tuple[Blocks, Blocks, Blocks]:
    """Consumes ``l1``/``l2`` (input blocks alias into the outputs)."""
    main: Blocks = []
    u1: Blocks = []
    u2: Blocks = []
    multiz(l1, l2, v, main.append, u1.append, u2.append,
           cfg=cfg, sp=sp)
    return main, u1, u2


def t_pair2tb(alis: Blocks, seq1: str, seq2: str) -> Blocks:
    """Consumes ``alis`` (one internal snapshot keeps the pass-through
    copies intact while get_maf_between/flip walk and mutate)."""
    out: Blocks = []
    out.extend(_cp(alis))
    work = get_maf_between(alis, seq1, out.append)
    flip_comps(work)
    get_maf_between(work, seq2, out.append)
    return out


def t_get_covered(l1: Blocks, l2: Blocks, sp=None) -> Blocks:
    """Consumes ``l1``/``l2`` (the lists; emitted blocks are fresh)."""
    out: Blocks = []
    cp1, cp2 = list(l1), list(l2)
    while cp1 and cp2:
        chrom = cp2[0].comps[0].src
        cp2, wk2 = separate_by_src(cp2, chrom)
        cp1, wk1 = separate_by_src(cp1, chrom)
        get_covered(wk1, wk2, out.append, sp=sp)
    return out


def t_strip_top(alis: Blocks, sp=None) -> Blocks:
    """get_rid_of_top (tba.c:46-70): drop the top row of every multi-row
    block, rescore; single-row blocks vanish. Consumes ``alis``."""
    out: Blocks = []
    for a in alis:
        if len(a.comps) > 1:
            a.comps = a.comps[1:]
            a.score = sc.score_range(a, 0, a.text_size, sp=sp)
            out.append(a)
    return out


# --------------------------------------------------------------------------
# tba (tba.c:100-276)
# --------------------------------------------------------------------------


class Tba:
    """In-memory tba_merge dataflow. Temp files A..Y/REF become locals;
    left.maf<id>/right.maf<id>/tba<id> become per-node block lists."""

    def __init__(
        self,
        tree: str,
        pair_files: List[str],
        src_dir: str = ".",
        cfg: MultizConfig | None = None,
        suffix: str = ".sing.maf",
        ref: Optional[str] = None,
        sp=None,
    ):
        self.tree = tree
        self.pair_files = list(pair_files)
        self.src_dir = src_dir
        self.cfg = cfg or MultizConfig()
        self.suffix = suffix
        self.ref = ref
        self.sp = sp
        self._mz = t_multiz
        self.tba: Dict[int, Blocks] = {}
        self.left: Dict[int, Blocks] = {}
        self.right: Dict[int, Blocks] = {}
        self._pair_cache: Dict[str, Blocks] = {}

    def _pair(self, a: str, b: str) -> Optional[Blocks]:
        name = f"{a}.{b}{self.suffix}"
        if name not in self.pair_files:
            return None
        # The reference re-reads the bz file per bridge-pair iteration
        # (tba.c:179); an in-memory parse cache serves shared-text
        # copies instead (tools consume their inputs, so each caller
        # needs fresh Ali/Comp wrappers but not fresh text buffers).
        cached = self._pair_cache.get(name)
        if cached is None:
            cached = read_maf(
                os.path.join(self.src_dir, name), verbose=False
            )
            self._pair_cache[name] = cached
        return [a_.copy_shared() for a_ in cached]

    def _seq(self, species: str) -> str:
        return os.path.join(self.src_dir, species)

    def _on_internal(self, left: TreeNode, right: TreeNode, nid: int):
        if left.id >= 0:
            self.left[nid] = self.tba.pop(left.id)
        else:
            self.left.setdefault(nid, [])
        if right.id >= 0:
            self.right[nid] = self.tba.pop(right.id)
        else:
            self.right.setdefault(nid, [])
        self.tba[nid] = []

    def _prep_names(self, x: TreeNode, y: TreeNode, nid: int):
        """The parse-time (name-only) half of tba_merge: move REF to the
        front of whichever side contains it and decide the side swap
        (tba.c:134-143). Mutates the parse nodes' name lists, so parents
        see the reordered lists; returns snapshots + swap flag."""
        if not x.names or not y.names:
            raise ValueError("merge_tree: empty sub tree")
        REF = self.ref
        if len(x.names) == 1 and len(y.names) == 1:
            return list(x.names), list(y.names), False
        if REF is not None and REF in x.names:
            x.names.remove(REF)
            x.names.insert(0, REF)
        swap = False
        if REF is not None and REF not in x.names and REF in y.names:
            y.names.remove(REF)
            y.names.insert(0, REF)
            x, y = y, x
            swap = True
        return list(x.names), list(y.names), swap

    def _merge(self, x: TreeNode, y: TreeNode, nid: int):
        n1s, n2s, swap = self._prep_names(x, y, nid)
        if swap:
            self.left[nid], self.right[nid] = (
                self.right[nid], self.left[nid],
            )
        self._merge_data(nid, n1s, n2s, swap)

    def _merge_data(self, nid: int, n1s, n2s, swap: bool):
        """The data half of tba_merge (tba.c:144-276); touches only this
        node's left/right/tba entries, so same-depth merges can run
        concurrently in the program (its tba_run parallel=)."""
        sp = self.sp
        cfg = self.cfg
        REF = self.ref

        # ---- leaf + leaf (tba.c:124-132) ----
        if len(n1s) == 1 and len(n2s) == 1:
            blocks = self._pair(n1s[0], n2s[0])
            if blocks is None:
                raise ValueError(
                    f"no alignment found for {n1s[0]} and {n2s[0]}"
                )
            proj, _ = t_project(blocks, n1s[0], with_others=False, sp=sp)
            self.tba[nid] = t_pair2tb(
                proj, self._seq(n1s[0]), self._seq(n2s[0])
            )
            return

        single_left = len(n1s) == 1
        single_right = len(n2s) == 1
        found = False
        single1 = single2 = 0
        for i1, n1 in enumerate(n1s):
            for i2, n2 in enumerate(n2s):
                blocks = self._pair(n1, n2)
                if blocks is None:
                    continue
                # rm/touch temp files (tba.c:180-181)
                A: Blocks = []
                B: Blocks = []
                C: Blocks = []
                D: Blocks = []
                E: Blocks = []
                F: Blocks = []
                T: Blocks = []
                U: Blocks = []
                W: Blocks = []
                Y: Blocks = []
                REFf: Blocks = []
                if not single_left:
                    # mp left.maf<id> n1 A > B (tba.c:183)
                    B, A = t_project(self.left[nid], n1, with_others=True, sp=sp)
                    if not single_right:
                        # mz B cmd 1 Y X > H (tba.c:185)
                        H, Y, _X = self._mz(B, blocks, 1, cfg, sp=sp)
                        # mp H n2 U > B (tba.c:186)
                        B, U = t_project(H, n2, with_others=True, sp=sp)
                        # mp right n2 C > D (tba.c:187)
                        D, C = t_project(
                            self.right[nid], n2, with_others=True, sp=sp
                        )
                        to_ref = REF is not None and (
                            (REF == n1 and i2 + 1 < len(n2s))
                            or (REF == n2 and i1 + 1 < len(n1s))
                        )
                        main, E, F = self._mz(D, B, 1, cfg, sp=sp)
                        if to_ref:
                            REFf = main  # "> REFf" (tba.c:189)
                        else:
                            self.tba[nid].extend(main)  # ">> tba<id>"
                        if REF is None or REF != n1:
                            # cat head F | mp - n2 W > H; strip top -> F
                            H2, W = t_project(F, n2, with_others=True, sp=sp)
                            F = t_strip_top(H2, sp=sp)
                    else:  # single_right (tba.c:198-217)
                        Xp, _ = t_project(blocks, n1, with_others=False, sp=sp)
                        D = t_pair2tb(Xp, self._seq(n1), self._seq(n2))
                        H, _V = t_project(D, n2, with_others=True, sp=sp)
                        if single2 == 0:
                            D, C = t_project(H, n1, with_others=True, sp=sp)
                            single2 += 1
                        else:
                            D2, _V = t_project(
                                self.right[nid], n2, with_others=True, sp=sp
                            )
                            L = t_get_covered(H, D2, sp=sp)
                            D, C = t_project(L, n1, with_others=True, sp=sp)
                        # mz B D 1 F E nohead >> tba<id> (tba.c:210)
                        main, F, E = self._mz(B, D, 1, cfg, sp=sp)
                        self.tba[nid].extend(main)
                        if REF is None or REF != n1:
                            H2, T = t_project(E, n1, with_others=True, sp=sp)
                            E = t_strip_top(H2, sp=sp)
                else:  # single_left (tba.c:219-240)
                    Xp, _ = t_project(blocks, n1, with_others=False, sp=sp)
                    B = t_pair2tb(Xp, self._seq(n1), self._seq(n2))
                    H, _V = t_project(B, n1, with_others=True, sp=sp)
                    if single1 == 0:
                        B, A = t_project(H, n2, with_others=True, sp=sp)
                        single1 += 1
                    else:
                        B2, _V = t_project(
                            self.left[nid], n1, with_others=True, sp=sp
                        )
                        L = t_get_covered(H, B2, sp=sp)
                        B, A = t_project(L, n2, with_others=True, sp=sp)
                    D, C = t_project(
                        self.right[nid], n2, with_others=True, sp=sp
                    )
                    # mz D B 1 E F nohead >> tba<id> (tba.c:232)
                    main, E, F = self._mz(D, B, 1, cfg, sp=sp)
                    self.tba[nid].extend(main)
                    if REF is None or REF != n1:
                        H2, W = t_project(F, n2, with_others=True, sp=sp)
                        F = t_strip_top(H2, sp=sp)

                # concats (tba.c:242-243)
                self.left[nid] = A + Y + U + F + W
                self.right[nid] = C + E + T
                if REF is not None and not single_left and not single_right:
                    if REF == n1 and i2 + 1 < len(n2s):
                        self.left[nid] = self.left[nid] + REFf
                    elif REF == n2 and i1 + 1 < len(n1s):
                        self.right[nid] = self.right[nid] + REFf
                found = True
        if not found:
            import sys

            sys.stderr.write(
                "Warning! No alignments connect tree with leaves:\n  "
                + " ".join(x.names) + "\nand tree with leaves:\n  "
                + " ".join(y.names) + "\n"
            )
        if swap:
            self.left[nid], self.right[nid] = (
                self.right[nid], self.left[nid],
            )


def tba_run(tree, pair_files, src_dir=".", cfg=None, suffix=".sing.maf",
            ref=None, sp=None) -> Blocks:
    """Full tba pipeline (tba.c:278-428); returns the destination blocks.
    The merges run one after another, as parseSpeciesTree runs them
    (speciesTree.c:71-110)."""
    import gc

    # Chromosome-scale runs allocate millions of small block objects;
    # the cyclic collector's generational scans cost ~20% of wall time
    # (measured, 2Mb config) and nothing here creates cycles — refcounts
    # free everything. Scope-limited disable, like the reference's
    # arena-free model (util.c ckalloc, never collected mid-run).
    _gc_was = gc.isenabled()
    if _gc_was:
        gc.disable()
    try:
        eng = Tba(tree, pair_files, src_dir, cfg, suffix, ref=ref, sp=sp)

        def op(x: TreeNode, y: TreeNode, nid: int):
            had = (x.id >= 0, y.id >= 0)
            eng._merge(x, y, nid)
            if had[0] or had[1]:
                eng.tba[nid].extend(eng.left.get(nid, []))
                eng.tba[nid].extend(eng.right.get(nid, []))

        _, last = parse_species_tree(
            eng.tree, op, on_internal=eng._on_internal
        )
        return eng.tba[last - 1]
    finally:
        if _gc_was:
            gc.enable()
