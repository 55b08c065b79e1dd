"""CLI mirroring tba (tba.c:278-428) on the port's DP backend.

args: [+-] [R=?] [M=?] [E=?] [P=?] [X=?] species-guide-tree maf-source... destination

Same argv and output as ``multiz_tpu.cli.tba``; the DP backend comes
from ``multiz_tpu_torch.ops.dispatch`` (MULTIZ_TPU_TORCH_DEVICE).
"""

from __future__ import annotations

import sys

from multiz_tpu import scores as sc
from multiz_tpu.cli.tba import SUFFIXES, VERSION
from multiz_tpu.maf import write_ali
from multiz_tpu.multiz import MultizConfig
from multiz_tpu.tree import tba_run

from ..ops.dispatch import default_batch_fn


def parse_tree_args(argv, cmd, allow=("R", "M", "E", "P", "X")):
    cfg = MultizConfig(batch_fn=default_batch_fn())
    ref = None
    suffix = ".sing.maf"
    aligner = "multiz"
    # '-' = dry-run (print the merge plan, execute nothing); '+' = verbose
    # (print the plan, then run) (speciesTree.c:27-34, tba.c:336-347)
    mode = argv.pop(0) if argv and argv[0] in ("+", "-") else None
    while argv and argv[0][:1] in allow and argv[0][1:2] == "=":
        key, val = argv[0][0], argv[0][2:]
        if key == "E":
            ref = val
        elif key == "P":
            # strstr semantics (tba.c:353-356)
            if val in "multic":
                aligner = "multic"
            elif val not in "multiz":
                raise SystemExit(f"{cmd}: aligner can be multiz or multic only")
        elif key == "X":
            x = int(val)
            if x not in SUFFIXES:
                raise SystemExit(f"{cmd}: Parameter X can only be 0, 1, 2")
            suffix = SUFFIXES[x]
        elif key == "R":
            cfg.radius = int(val)
        elif key == "M":
            cfg.min_output_wid = int(val)
        # T= and C= are accepted no-ops, as in the reference
        argv.pop(0)
    return cfg, ref, suffix, aligner, mode


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = f"tba.v{VERSION}"
    args_line = " ".join(argv)
    cfg, ref, suffix, aligner, mode = parse_tree_args(argv, cmd)
    if len(argv) < 3:
        raise SystemExit(
            f"{cmd}: args: [+-] [R=?] [M=?] [E=?] [P=?] [X=?] "
            "species-guide-tree maf-source destination"
        )
    dest = argv[-1]
    tree = argv[0]
    if len(argv) == 4 and argv[1] == "-f":
        with open(argv[2]) as fh:
            pair_files = [l.rstrip("\n") for l in fh if l.strip()]
    else:
        pair_files = argv[1:-1]

    if mode is not None:
        from multiz_tpu.tree import tba_plan

        out = sys.stdout if mode == "-" else sys.stderr
        for line in tba_plan(tree, pair_files, ref=ref, suffix=suffix,
                             aligner=aligner):
            out.write(line + "\n")
        if mode == "-":
            return 0  # dry run: plan only

    sp = sc.init_scores70()
    blocks = tba_run(tree, pair_files, src_dir=".", cfg=cfg, suffix=suffix,
                     ref=ref, sp=sp, aligner=aligner)
    with open(dest, "w") as out:
        out.write(f"##maf version={VERSION} scoring={cmd}\n")
        out.write(f"# {cmd} {args_line}\n")
        for a in blocks:
            write_ali(out, a)
        out.write("##eof maf\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
