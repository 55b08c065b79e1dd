"""Guide-tree parsing and the tba/roast merge schedules, in memory.

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

With ``MZ_TIME`` set, a run records its spans (``trace.py``): the root
``tba`` or ``roast``, ``tba.merge`` or ``roast.merge`` a tree node,
``maf.read`` a pair file parsed, ``maf_project``, ``threading.pair2tb`` /
``.get_covered`` / ``.strip_top`` a tool call, and ``multiz`` (with
``multic``'s calls).
Each bridging iteration of a tba merge (a pair file that joins the two
sides) adds one to the counter ``tba.bridge.<kind>`` with its wall
seconds, uncharged, by the branch of tba.c it takes (``bridge_kind``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import scores as sc
from . import trace
from .blocks import flip_comps, separate_by_src
from .maf import Ali, read_maf
from .maf_project import project
from .multic import MulticConfig, multic
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


@trace.traced("maf_project")
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


@trace.traced("multiz")
def t_multic(l1: Blocks, l2: Blocks, v: int, cfg: MultizConfig,
             sp=None) -> Tuple[Blocks, Blocks, Blocks]:
    """multic with the multiz argv shape (tba.c:17-18: P=multic swaps the
    aligner executable inside the same command strings). Consumes
    ``l1``/``l2``."""
    mcfg = MulticConfig(
        radius=cfg.radius, min_output_wid=cfg.min_output_wid, row2=cfg.row2
    )
    main: Blocks = []
    u1: Blocks = []
    u2: Blocks = []
    multic(l1, l2, v, main.append, u1.append, u2.append,
           cfg=mcfg, sp=sp)
    return main, u1, u2


@trace.traced("threading.pair2tb")
def t_pair2tb(alis: Blocks, seq1: str, seq2: str) -> Blocks:
    """Consumes ``alis`` (one internal snapshot keeps the pass-through
    copies intact while get_maf_between/flip walk and mutate)."""
    out: Blocks = []
    out.extend(_cp(alis))
    work = get_maf_between(alis, seq1, out.append)
    flip_comps(work)
    get_maf_between(work, seq2, out.append)
    return out


@trace.traced("threading.get_covered")
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


@trace.traced("threading.strip_top")
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
# roast (auto_mz.c:52-118)
# --------------------------------------------------------------------------


class Roast:
    def __init__(
        self,
        ref: str,
        tree: str,
        pair_files: List[str],
        src_dir: str = ".",
        cfg: MultizConfig | None = None,
        suffix: str = ".sing.maf",
        sp=None,
        aligner: str = "multiz",
    ):
        self.ref = ref
        self.tree = tree
        self.pair_files = list(pair_files)
        self.src_dir = src_dir
        self.cfg = cfg or MultizConfig()
        self.suffix = suffix
        self.sp = sp
        self._mz = t_multic if aligner == "multic" else t_multiz
        self.mz: Dict[int, Blocks] = {}  # MZ<id> accumulators
        self.left: Dict[int, Blocks] = {}  # left.maf<id>
        self.right: Dict[int, Blocks] = {}

    def _read_pair(self, a: str, b: str) -> Optional[Blocks]:
        name = f"{a}.{b}{self.suffix}"
        if name not in self.pair_files:
            return None
        with trace.span("maf.read"):
            return read_maf(os.path.join(self.src_dir, name), verbose=False)

    def _on_internal(self, left: TreeNode, right: TreeNode, nid: int):
        # speciesTree.c:76-81: mv child outputs into left/right.maf<id>
        if left.id >= 0:
            self.left[nid] = self.mz.pop(left.id)
        else:
            self.left.setdefault(nid, [])
        if right.id >= 0:
            self.right[nid] = self.mz.pop(right.id)
        else:
            self.right.setdefault(nid, [])
        self.mz[nid] = []

    def _merge(self, x: TreeNode, y: TreeNode, nid: int):
        """mz_merge (auto_mz.c:52-118). A span ``roast.merge``."""
        n1, n2 = x.names, y.names
        v = roast_v(self.ref, n1, n2)
        with trace.span("roast.merge", nid=nid, v=v, left=tuple(n1),
                        right=tuple(n2)):
            self._merge_node(n1, n2, nid, v)

    def _merge_node(self, n1: List[str], n2: List[str], nid: int, v):
        REF = self.ref
        if v == "ref-leaf":  # REF-containing leaf shortcuts
            if n1 == [REF]:
                own, other, side = n1, n2, self.right
            else:
                own, other, side = n2, n1, self.left
            if len(other) == 1:
                blocks = self._read_pair(own[0], other[0])
                self.mz[nid].extend(blocks or [])
            else:
                self.mz[nid].extend(side.get(nid, []))
            self.left[nid] = []
            self.right[nid] = []
            return

        if len(n1) == 1:
            self.left[nid] = self._read_pair(REF, n1[0]) or []
        if len(n2) == 1:
            self.right[nid] = self._read_pair(REF, n2[0]) or []

        # project both sides onto REF; the projection replaces the file,
        # others are discarded (auto_mz.c:92-95)
        lproj, _ = t_project(self.left[nid], REF, with_others=True, sp=self.sp)
        rproj, _ = t_project(self.right[nid], REF, with_others=True, sp=self.sp)
        self.left[nid] = lproj
        self.right[nid] = rproj

        if v == 0:
            main, u1, u2 = self._mz(
                self.left[nid], self.right[nid], 0, self.cfg, sp=self.sp
            )
            self.mz[nid].extend(main)
            if len(n1) == 1 and len(n2) == 1:
                self.mz[nid].extend(u1)
                self.mz[nid].extend(u2)
                return
        else:
            if REF in n2:
                self.left[nid], self.right[nid] = (
                    self.right[nid], self.left[nid],
                )
            main, u1, u2 = self._mz(
                self.left[nid], self.right[nid], 1, self.cfg, sp=self.sp
            )
            self.mz[nid].extend(main)
        self.left[nid] = u1
        self.right[nid] = u2


def roast_v(ref: str, n1s, n2s):
    """What a roast node does, by its sides' species: ``"ref-leaf"``
    where one side is the reference alone (auto_mz.c:58-81: no multiz
    call), else the v of its multiz call: 1 where a side holds the
    reference, 0 where neither does."""
    if [ref] in (list(n1s), list(n2s)):
        return "ref-leaf"
    return 1 if ref in n1s or ref in n2s else 0


def roast_run(ref, tree, pair_files, src_dir=".", cfg=None, suffix=".sing.maf",
              sp=None, aligner="multiz") -> Blocks:
    """Full roast pipeline (auto_mz.c:120-285): merge per guide-tree node,
    final projection onto the reference."""
    import gc

    _gc_was = gc.isenabled()
    if _gc_was:
        gc.disable()  # see tba_run: no cycles, ~20% of wall in GC scans
    try:
        with trace.run("roast"):
            return _roast_run_inner(ref, tree, pair_files, src_dir, cfg,
                                    suffix, sp, aligner)
    finally:
        if _gc_was:
            gc.enable()


def _roast_run_inner(ref, tree, pair_files, src_dir, cfg, suffix, sp,
                     aligner) -> Blocks:
    eng = Roast(ref, tree, pair_files, src_dir, cfg, suffix, sp=sp,
                aligner=aligner)

    def op(x: TreeNode, y: TreeNode, nid: int):
        # parseSpeciesTree appends leftover left/right.maf<id> after the
        # operation when either child was an internal node
        # (speciesTree.c:83-89)
        had = (x.id >= 0, y.id >= 0)
        eng._merge(x, y, nid)
        if had[0] or had[1]:
            eng.mz[nid].extend(eng.left.get(nid, []))
            eng.mz[nid].extend(eng.right.get(nid, []))

    _, last = parse_species_tree(tree, op, on_internal=eng._on_internal)
    final = eng.mz[last - 1]
    proj, _ = t_project(final, ref, with_others=True, sp=sp)
    return proj


# --------------------------------------------------------------------------
# tba (tba.c:100-276)
# --------------------------------------------------------------------------


def bridge_kind(n1s, n2s) -> str:
    """The branch of tba_merge a node takes, by its sides' sizes: ``ll``
    leaf + leaf (tba.c:124-132), ``ml`` multi x leaf (tba.c:198-217),
    ``lm`` leaf x multi (tba.c:219-240), ``mm`` multi x multi
    (tba.c:183-197)."""
    return ("l" if len(n1s) == 1 else "m") + ("l" if len(n2s) == 1 else "m")


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
        aligner: str = "multiz",
    ):
        self.tree = tree
        self.pair_files = list(pair_files)
        self.src_dir = src_dir
        self.cfg = cfg or MultizConfig()
        self.suffix = suffix
        self.ref = ref
        self.sp = sp
        # P=multic swaps the aligner inside the same commands (tba.c:17-18)
        self._mz = t_multic if aligner == "multic" else t_multiz
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
            with trace.span("maf.read"):
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
        concurrently (see tba_run parallel=). A span ``tba.merge``."""
        with trace.span("tba.merge", nid=nid, kind=bridge_kind(n1s, n2s),
                        left=tuple(n1s), right=tuple(n2s)):
            self._merge_nodes(nid, n1s, n2s, swap)

    def _merge_nodes(self, nid: int, n1s, n2s, swap: bool):
        sp = self.sp
        cfg = self.cfg
        REF = self.ref
        timed = trace.on  # a bridge's seconds: tba.bridge.<kind>, uncharged
        bridge = "tba.bridge." + bridge_kind(n1s, n2s)

        # ---- leaf + leaf (tba.c:124-132) ----
        if len(n1s) == 1 and len(n2s) == 1:
            t0 = time.perf_counter() if timed else 0.0
            blocks = self._pair(n1s[0], n2s[0])
            if blocks is None:
                raise ValueError(
                    f"no alignment found for {n1s[0]} and {n2s[0]}"
                )
            proj, _ = t_project(blocks, n1s[0], with_others=False, sp=sp)
            self.tba[nid] = t_pair2tb(
                proj, self._seq(n1s[0]), self._seq(n2s[0])
            )
            if timed:
                trace.count(bridge, time.perf_counter() - t0, charge=False)
            return

        single_left = len(n1s) == 1
        single_right = len(n2s) == 1
        found = False
        single1 = single2 = 0
        for i1, n1 in enumerate(n1s):
            for i2, n2 in enumerate(n2s):
                t0 = time.perf_counter() if timed else 0.0
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
                if timed:
                    trace.count(bridge, time.perf_counter() - t0,
                                charge=False)
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


def tba_plan(tree, pair_files, ref=None, suffix=".sing.maf",
             aligner="multiz") -> List[str]:
    """Printable merge plan of tba_run — the in-process analog of the
    reference's dry-run/verbose facility, which prints each generated
    shell pipeline (speciesTree.c:27-34, tba.c:336-341). Mirrors the
    name-level control flow of Tba._merge_data; temp-file letters
    (A..Y, REFf) match the reference's /tmp/_tba_<pid>_* naming."""
    eng = Tba(tree, pair_files, ".", None, suffix, ref=ref, aligner=aligner)
    tasks = []

    def record(x: TreeNode, y: TreeNode, nid: int):
        n1s, n2s, swap = eng._prep_names(x, y, nid)
        tasks.append((nid, n1s, n2s, swap))

    parse_species_tree(tree, record, on_internal=None)
    mz = "multic" if aligner == "multic" else "multiz"
    have = set(pair_files)
    lines: List[str] = []
    for nid, n1s, n2s, swap in tasks:
        lines.append(
            f"node {nid}: merge ({' '.join(n1s)}) + ({' '.join(n2s)})"
            + (" [sides swapped: ref]" if swap else "")
        )
        if len(n1s) == 1 and len(n2s) == 1:
            pf = f"{n1s[0]}.{n2s[0]}{suffix}"
            if pf in have:
                lines.append(
                    f"  maf_project {pf} {n1s[0]}; pair2tb -> tba{nid}"
                )
            else:
                lines.append(
                    f"  ERROR: no alignment found for {n1s[0]} and {n2s[0]}"
                )
            continue
        single_left = len(n1s) == 1
        single_right = len(n2s) == 1
        found = False
        single1 = single2 = 0
        for i1, n1 in enumerate(n1s):
            for i2, n2 in enumerate(n2s):
                pf = f"{n1}.{n2}{suffix}"
                if pf not in have:
                    continue
                lines.append(f"  bridge {pf}:")
                if not single_left:
                    lines.append(f"    maf_project left{nid} {n1} A > B")
                    if not single_right:
                        lines.append(f"    {mz} B {pf} 1 Y X > H")
                        lines.append(f"    maf_project H {n2} U > B")
                        lines.append(f"    maf_project right{nid} {n2} C > D")
                        to_ref = ref is not None and (
                            (ref == n1 and i2 + 1 < len(n2s))
                            or (ref == n2 and i1 + 1 < len(n1s))
                        )
                        lines.append(
                            f"    {mz} D B 1 E F >> "
                            + ("REFf" if to_ref else f"tba{nid}")
                        )
                        if ref is None or ref != n1:
                            lines.append(
                                f"    maf_project F {n2} W; strip-top > F"
                            )
                    else:
                        lines.append(
                            f"    maf_project {pf} {n1}; pair2tb > D; "
                            f"maf_project D {n2} > H"
                        )
                        if single2 == 0:
                            lines.append(f"    maf_project H {n1} C > D")
                            single2 += 1
                        else:
                            lines.append(
                                f"    maf_project right{nid} {n2} > D2; "
                                f"get_covered H D2 > L; "
                                f"maf_project L {n1} C > D"
                            )
                        lines.append(f"    {mz} B D 1 F E >> tba{nid}")
                        if ref is None or ref != n1:
                            lines.append(
                                f"    maf_project E {n1} T; strip-top > E"
                            )
                else:
                    lines.append(
                        f"    maf_project {pf} {n1}; pair2tb > B; "
                        f"maf_project B {n1} > H"
                    )
                    if single1 == 0:
                        lines.append(f"    maf_project H {n2} A > B")
                        single1 += 1
                    else:
                        lines.append(
                            f"    maf_project left{nid} {n1} > B2; "
                            f"get_covered H B2 > L; "
                            f"maf_project L {n2} A > B"
                        )
                    lines.append(f"    maf_project right{nid} {n2} C > D")
                    lines.append(f"    {mz} D B 1 E F >> tba{nid}")
                    if ref is None or ref != n1:
                        lines.append(
                            f"    maf_project F {n2} W; strip-top > F"
                        )
                lines.append(
                    f"    left{nid} = A+Y+U+F+W; right{nid} = C+E+T"
                )
                found = True
        if not found:
            lines.append("  WARNING: no alignments connect the subtrees")
    return lines


def roast_plan(ref, tree, pair_files, suffix=".sing.maf",
               aligner="multiz") -> List[str]:
    """Printable merge plan of roast_run (mz_merge dataflow,
    auto_mz.c:52-118); see tba_plan."""
    tasks = []

    def record(x: TreeNode, y: TreeNode, nid: int):
        tasks.append((nid, list(x.names), list(y.names)))

    parse_species_tree(tree, record, on_internal=None)
    mz = "multic" if aligner == "multic" else "multiz"
    have = set(pair_files)
    lines: List[str] = []
    for nid, n1s, n2s in tasks:
        lines.append(f"node {nid}: merge ({' '.join(n1s)}) + ({' '.join(n2s)})")
        for ns, other, side in ((n1s, n2s, "right"), (n2s, n1s, "left")):
            if len(ns) == 1 and ns[0] == ref:
                if len(other) == 1:
                    pf = f"{ref}.{other[0]}{suffix}"
                    lines.append(
                        f"  copy {pf} > MZ{nid}" if pf in have
                        else f"  ERROR: missing {pf}"
                    )
                else:
                    lines.append(f"  copy {side}{nid} > MZ{nid}")
                break
        else:
            lines.append(f"  maf_project left{nid} {ref} > left{nid}")
            lines.append(f"  maf_project right{nid} {ref} > right{nid}")
            v = 1 if (ref in n1s or ref in n2s) else 0
            swapped = " [sides swapped: ref]" if ref in n2s else ""
            lines.append(
                f"  {mz} left right {v} U1 U2 >> MZ{nid}{swapped}"
            )
    lines.append(f"final: maf_project MZ{tasks[-1][0]} {ref} > dest")
    return lines


class SharedBatch:
    """Cross-node DP batching for concurrent tree merges (VERDICT r2
    item 6). Each merge thread's per-round DP job list is pooled with
    every other thread's and executed as ONE device batch, keeping
    launches wide through the whole tree (the reference runs merges —
    and therefore DPs — strictly sequentially, speciesTree.c:71-110).

    Dispatch fires when every ACTIVE merge thread (deps satisfied, past
    ``enter()``) is parked here, or after ``wait_s`` — so a thread never
    stalls behind another thread's host-side phase for long. Results
    are split back per submitter; batching cannot change them (the
    batch backend buckets by shape and is bit-exact per job)."""

    def __init__(self, inner: Callable, wait_s: float | None = None):
        import threading

        if wait_s is None:
            wait_s = float(os.environ.get("MZ_BATCH_WAIT", "0.05"))
        self.inner = inner
        self.wait_s = wait_s
        self.cv = threading.Condition()
        self.active = 0
        self.queue: list = []  # [jobs, sp, result, done, err]

    def enter(self) -> None:
        with self.cv:
            self.active += 1

    def leave(self) -> None:
        with self.cv:
            self.active -= 1
            self.cv.notify_all()

    def __call__(self, jobs, sp=None):
        import time as _time

        entry = [list(jobs), sp, None, False, None]
        with self.cv:
            self.queue.append(entry)
            deadline = _time.monotonic() + self.wait_s
            while not entry[3]:
                now = _time.monotonic()
                if len(self.queue) >= self.active or now >= deadline:
                    # identity test: value-equality (`in`) would compare
                    # job tuples of ndarrays and raise, or alias two
                    # distinct entries with equal job lists
                    if any(e is entry for e in self.queue):
                        self._dispatch()  # I lead; serves current queue
                        continue
                    # someone else is mid-dispatch with my entry
                    self.cv.wait(timeout=0.005)
                else:
                    self.cv.wait(timeout=max(deadline - now, 0.001))
        if entry[4] is not None:
            raise entry[4]
        return entry[2]

    def _dispatch(self) -> None:
        # called with self.cv held; releases it around the device call
        batch, self.queue = self.queue, []
        allj = [j for e in batch for j in e[0]]
        sp = batch[0][1]
        # one pooled device call serves the whole batch with ONE sp
        assert all(e[1] is sp for e in batch), (
            "SharedBatch entries must share score params"
        )
        self.cv.release()
        try:
            try:
                outs = self.inner(allj, sp=sp)
                off = 0
                for e in batch:
                    e[2] = outs[off : off + len(e[0])]
                    off += len(e[0])
            except BaseException as exc:  # propagate to every waiter
                for e in batch:
                    e[4] = exc
        finally:
            for e in batch:
                e[3] = True
            self.cv.acquire()
            self.cv.notify_all()


def tba_run(tree, pair_files, src_dir=".", cfg=None, suffix=".sing.maf",
            ref=None, sp=None, aligner="multiz",
            parallel: int | None = None) -> Blocks:
    """Full tba pipeline (tba.c:278-428); returns the destination blocks.

    With ``parallel`` > 1, independent tree merges (nodes that are not
    ancestors of each other) run concurrently on a thread pool; outputs
    are deterministic because each merge reads only its children's
    results and the final blockset is the root node's accumulator (the
    reference runs all merges strictly sequentially via
    parseSpeciesTree, speciesTree.c:71-110)."""
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
        with trace.run("tba"):
            return _tba_run_inner(tree, pair_files, src_dir, cfg, suffix,
                                  ref, sp, aligner, parallel)
    finally:
        if _gc_was:
            gc.enable()


def _tba_run_inner(tree, pair_files, src_dir, cfg, suffix, ref, sp,
                   aligner, parallel) -> Blocks:
    eng = Tba(tree, pair_files, src_dir, cfg, suffix, ref=ref, sp=sp,
              aligner=aligner)

    if not parallel or parallel <= 1:
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

    # ---- two-phase schedule: record merges at parse time (name-only
    # mutations happen here, sequentially), execute concurrently ----
    import threading
    from concurrent.futures import ThreadPoolExecutor

    tasks = []

    def record(x: TreeNode, y: TreeNode, nid: int):
        had = (x.id >= 0, y.id >= 0)
        n1s, n2s, swap = eng._prep_names(x, y, nid)
        tasks.append((nid, x.id, y.id, n1s, n2s, swap, had))

    _, last = parse_species_tree(eng.tree, record, on_internal=None)

    events = {t[0]: threading.Event() for t in tasks}
    root = trace.current()  # the run's root span, for the merge threads

    failed: dict[int, BaseException] = {}

    # pool DP jobs from concurrent merges into shared device batches
    shared = None
    if eng.cfg.batch_fn is not None:
        from dataclasses import replace as _dc_replace

        shared = SharedBatch(eng.cfg.batch_fn)
        eng.cfg = _dc_replace(eng.cfg, batch_fn=shared)

    def runner(task):
        # events are set in the finally block even on failure — otherwise a
        # raising merge would leave its dependents waiting forever and the
        # executor shutdown would hang the whole run.
        nid, x_id, y_id, n1s, n2s, swap, had = task
        try:
            if x_id >= 0:
                events[x_id].wait()
            if y_id >= 0:
                events[y_id].wait()
            if x_id in failed or y_id in failed:
                raise RuntimeError(f"tba merge {nid}: upstream merge failed")
            if shared is not None:
                shared.enter()
            try:
                left = eng.tba.pop(x_id) if x_id >= 0 else []
                right = eng.tba.pop(y_id) if y_id >= 0 else []
                if swap:
                    left, right = right, left
                eng.left[nid] = left
                eng.right[nid] = right
                eng.tba[nid] = []
                with trace.attach(root):
                    eng._merge_data(nid, n1s, n2s, swap)
                if had[0] or had[1]:
                    eng.tba[nid].extend(eng.left.get(nid, []))
                    eng.tba[nid].extend(eng.right.get(nid, []))
            finally:
                if shared is not None:
                    shared.leave()
        except BaseException as e:
            failed[nid] = e
            raise
        finally:
            events[nid].set()

    with ThreadPoolExecutor(max_workers=parallel) as ex:
        futs = [ex.submit(runner, t) for t in tasks]
        # tasks are recorded bottom-up, so the first failing future in
        # submission order carries the root-cause exception.
        for f in futs:
            f.result()
    return eng.tba[last - 1]
