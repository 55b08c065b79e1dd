"""Entry ``tba``: ``tree.tba_run`` on the program's packed DP stream, the
MAF rendered in memory, back to back over one region.

The window's operation is one whole tba over the cell's region, as the
``tba`` CLI runs it at the card's default routing:
``MultizConfig(batch_fn=ops.yama_pack.batch_fn_for(device))``, then
``maf.format_ali`` over the blocks. Its work is the region's reference
bases. Set-up makes the region from the seed and runs the mix's
``warm_runs`` tbas over it: a shorter region leaves the first tba of the
window slower (allocator and heap growth at the region's sizes).

The check runs the reference tba (``reference/tba.py``) once over the
region, or reads its MAF from an earlier run of the same cell and seed
(``cache.py``), and compares the rendered MAF of every tba of the window
with it, block by block: ``maf_blocks_differing`` counts the blocks that
differ, summed over the tbas, limit 0.
"""

from __future__ import annotations

import sys

from .. import cache
from ..reference import tba as reference
from ..traffic import tba_region


def blocks_differing(a: str, b: str) -> int:
    """MAF blocks (paragraphs) at which two renderings differ, plus the
    difference in their counts."""
    if a == b:
        return 0
    pa, pb = a.split("\n\n"), b.split("\n\n")
    return sum(x != y for x, y in zip(pa, pb)) + abs(len(pa) - len(pb))


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.texts: list = []

    def setup(self) -> None:
        ctx = self.ctx
        mix, cfg = ctx.mix, ctx.config
        self.ds = tba_region.make(cfg, int(mix["region_bases"]), ctx.seed, 1,
                                  ctx.subdir("region"))
        from multiz_tpu_torch import maf, scores
        from multiz_tpu_torch.multiz import MultizConfig
        from multiz_tpu_torch.ops import yama_pack
        from multiz_tpu_torch.tree import tba_run

        self.yama_pack = yama_pack
        bf = yama_pack.batch_fn_for(ctx.device)
        sp = scores.init_scores70()
        radius = int(cfg["tba"]["radius"])
        min_wid = int(cfg["tba"]["min_output_wid"])

        self.tba_cfg = {"radius": radius, "min_output_wid": min_wid}

        def program(ds) -> str:
            blocks = tba_run(ds["tree"], list(ds["pairs"]),
                             src_dir=ds["src_dir"],
                             cfg=MultizConfig(radius=radius,
                                              min_output_wid=min_wid,
                                              batch_fn=bf), sp=sp)
            return "".join(maf.format_ali(a) for a in blocks)

        def control(ds) -> str:  # the control in the program's place
            return reference.maf(ds, ctx.device, **self.tba_cfg,
                                 **ctx.control)

        self.one = program if ctx.control is None else control
        for _ in range(int(mix["warm_runs"])):
            self.one(self.ds)

    def op(self) -> int:
        self.texts.append(self.one(self.ds))
        return int(self.ds["ref_bases"])

    def check(self) -> dict:
        """{number: (value, limit)} once the window has closed."""
        t = {}
        ref, kept = cache.text(
            cache.path(self.ctx, "ref.maf.gz"),
            lambda: reference.maf(self.ds, self.ctx.device, **self.tba_cfg,
                                  times=t))
        print("# reference: kept from an earlier run" if kept else
              f"# reference: DP {t['dp_s']:.3f} s of {t['all_s']:.3f} s",
              file=sys.stderr)
        return {"maf_blocks_differing": (
            sum(blocks_differing(t, ref) for t in self.texts), 0)}

    def release(self) -> None:
        self.one = None
