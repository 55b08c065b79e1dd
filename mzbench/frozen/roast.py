# Frozen copy of multiz_tpu_torch/tree.py's roast (Roast, roast_run) at
# commit 1de2067, kept by the benchmark (mzbench/) so that its reference
# never imports the program. Changes: on the frozen tree, maf, maf_project
# and multiz (numpy only, the native runtime never loaded); multiz is the
# only aligner (the original's P=multic is cut).
"""The roast merge schedule (auto_mz.c:52-285), in memory: the reference
species' pairwise alignments merged progressively up the guide tree, each
node's sides projected onto the reference, then the whole projected once
more."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from .maf import read_maf
from .multiz import MultizConfig
from .tree import Blocks, TreeNode, parse_species_tree, t_multiz, t_project


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
    ):
        self.ref = ref
        self.tree = tree
        self.pair_files = list(pair_files)
        self.src_dir = src_dir
        self.cfg = cfg or MultizConfig()
        self.suffix = suffix
        self.sp = sp
        self._mz = t_multiz
        self.mz: Dict[int, Blocks] = {}  # MZ<id> accumulators
        self.left: Dict[int, Blocks] = {}  # left.maf<id>
        self.right: Dict[int, Blocks] = {}

    def _read_pair(self, a: str, b: str) -> Optional[Blocks]:
        name = f"{a}.{b}{self.suffix}"
        if name not in self.pair_files:
            return None
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
        """mz_merge (auto_mz.c:52-118)."""
        REF = self.ref
        n1, n2 = x.names, y.names
        # REF-containing leaf shortcuts
        if len(n1) == 1 and n1[0] == REF:
            if len(n2) == 1:
                blocks = self._read_pair(n1[0], n2[0])
                self.mz[nid].extend(blocks or [])
            else:
                self.mz[nid].extend(self.right.get(nid, []))
            self.left[nid] = []
            self.right[nid] = []
            return
        if len(n2) == 1 and n2[0] == REF:
            if len(n1) == 1:
                blocks = self._read_pair(n2[0], n1[0])
                self.mz[nid].extend(blocks or [])
            else:
                self.mz[nid].extend(self.left.get(nid, []))
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

        left_has = REF in n1
        right_has = REF in n2
        if not left_has and not right_has:
            main, u1, u2 = self._mz(
                self.left[nid], self.right[nid], 0, self.cfg, sp=self.sp
            )
            self.mz[nid].extend(main)
            if len(n1) == 1 and len(n2) == 1:
                self.mz[nid].extend(u1)
                self.mz[nid].extend(u2)
                return
        else:
            if right_has:
                self.left[nid], self.right[nid] = (
                    self.right[nid], self.left[nid],
                )
            main, u1, u2 = self._mz(
                self.left[nid], self.right[nid], 1, self.cfg, sp=self.sp
            )
            self.mz[nid].extend(main)
        self.left[nid] = u1
        self.right[nid] = u2


def roast_run(ref, tree, pair_files, src_dir=".", cfg=None, suffix=".sing.maf",
              sp=None) -> Blocks:
    """Full roast pipeline (auto_mz.c:120-285): merge per guide-tree node,
    final projection onto the reference."""
    import gc

    _gc_was = gc.isenabled()
    if _gc_was:
        gc.disable()  # see tba_run: no cycles, ~20% of wall in GC scans
    try:
        return _roast_run_inner(ref, tree, pair_files, src_dir, cfg,
                                suffix, sp)
    finally:
        if _gc_was:
            gc.enable()


def _roast_run_inner(ref, tree, pair_files, src_dir, cfg, suffix,
                     sp) -> Blocks:
    eng = Roast(ref, tree, pair_files, src_dir, cfg, suffix, sp=sp)

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
