"""Entry ``roast_tree``: ``tree.roast_run`` on the program's packed DP
stream, the MAF rendered in memory, back to back over one region of the
traffic kind ``tba_tree_region``, checked block by block against
``reference/roast.py``.

The window's operation is one whole roast E=<reference> over the cell's
region, as the ``roast`` CLI runs it at the card's default routing:
``MultizConfig(radius, min_output_wid,
batch_fn=ops.yama_pack.batch_fn_for(device))``, then ``maf.format_ali``
over the blocks. The region holds the pairwise MAF of every pair the
tree joins; the roast is handed only the pairs with the reference first
(``reference.roast.ref_pairs``), the ones ``all_bz``'s roast mode (D=0)
writes. Its work is the region's reference bases. Set-up makes the
region from the seed and runs the mix's ``warm_runs`` roasts over it.

Built on entry ``tba``: the same operation and release, and the same
check (``maf_blocks_differing``, the blocks at which a roast's MAF
differs from the reference's, summed over the window's roasts, limit 0;
the reference worked out once per seed or read back, ``cache.py``).
"""

from __future__ import annotations

import sys

from .. import cache
from ..reference import roast as reference
from ..traffic import tba_tree_region
from . import tba


class Entry(tba.Entry):
    def setup(self) -> None:
        ctx = self.ctx
        mix, cfg = ctx.mix, ctx.config
        self.ds = tba_tree_region.make(cfg, int(mix["region_bases"]),
                                       ctx.seed, 1, ctx.subdir("region"))
        from multiz_tpu_torch import maf, scores
        from multiz_tpu_torch.multiz import MultizConfig
        from multiz_tpu_torch.ops import yama_pack
        from multiz_tpu_torch.tree import roast_run

        self.yama_pack = yama_pack
        bf = yama_pack.batch_fn_for(ctx.device)
        sp = scores.init_scores70()
        opts = cfg["roast"]
        ref = opts["reference"]
        radius = int(opts["radius"])
        min_wid = int(opts["min_output_wid"])
        self.roast_cfg = {"ref": ref, "radius": radius,
                          "min_output_wid": min_wid}
        pairs = reference.ref_pairs(self.ds, ref)

        def program(ds) -> str:
            blocks = roast_run(ref, ds["tree"], pairs, src_dir=ds["src_dir"],
                               cfg=MultizConfig(radius=radius,
                                                min_output_wid=min_wid,
                                                batch_fn=bf), sp=sp)
            return "".join(maf.format_ali(a) for a in blocks)

        def control(ds) -> str:  # the control in the program's place
            return reference.maf(ds, ctx.device, **self.roast_cfg,
                                 **ctx.control)

        self.one = program if ctx.control is None else control
        for _ in range(int(mix["warm_runs"])):
            self.one(self.ds)

    def check(self) -> dict:
        """{number: (value, limit)} once the window has closed."""
        t = {}
        ref, kept = cache.text(
            cache.path(self.ctx, "ref.maf.gz"),
            lambda: reference.maf(self.ds, self.ctx.device, **self.roast_cfg,
                                  times=t))
        print("# reference: kept from an earlier run" if kept else
              f"# reference: DP {t['dp_s']:.3f} s of {t['all_s']:.3f} s",
              file=sys.stderr)
        return {"maf_blocks_differing": (
            sum(tba.blocks_differing(text, ref) for text in self.texts), 0)}
