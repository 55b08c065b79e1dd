"""CLI mirroring roast (auto_mz.c:120-285) on the port's DP backend.

args: [+-] [R=?] [M=?] [P=?] [T=?] [X=?] [C=?] E=reference
      species-guide-tree maf-source... destination

Same argv and output as ``multiz_tpu.cli.roast``.
"""

from __future__ import annotations

import sys

from multiz_tpu import scores as sc
from multiz_tpu.cli.roast import VERSION
from multiz_tpu.maf import write_ali
from multiz_tpu.tree import roast_run

from .tba import parse_tree_args


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = f"roast.v{VERSION}"
    args_line = " ".join(argv)
    cfg, ref, suffix, aligner, mode = parse_tree_args(
        argv, cmd, allow=("R", "M", "E", "P", "X", "C", "T")
    )
    if ref is None:
        raise SystemExit(f"{cmd}: reference is not specified (E=...)")
    if len(argv) < 3:
        raise SystemExit(
            f"{cmd}: args: [+-] [R=?] [M=?] [P=?] [T=?] [X=?] [C=?] "
            "E=reference species-guide-tree maf-source destination"
        )
    dest = argv[-1]
    tree = argv[0]
    if len(argv) == 4 and argv[1] == "-f":
        with open(argv[2]) as fh:
            pair_files = [l.rstrip("\n") for l in fh if l.strip()]
    else:
        pair_files = argv[1:-1]

    if mode is not None:
        from multiz_tpu.tree import roast_plan

        out = sys.stdout if mode == "-" else sys.stderr
        for line in roast_plan(ref, tree, pair_files, suffix=suffix,
                               aligner=aligner):
            out.write(line + "\n")
        if mode == "-":
            return 0  # dry run: plan only

    sp = sc.init_scores70()
    blocks = roast_run(ref, tree, pair_files, src_dir=".", cfg=cfg,
                       suffix=suffix, sp=sp, aligner=aligner)
    with open(dest, "w") as out:
        out.write(f"##maf version=1 scoring={cmd}.{VERSION}\n")
        out.write(f"# {cmd} {args_line}\n")
        for a in blocks:
            write_ali(out, a)
        out.write("##eof maf\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
