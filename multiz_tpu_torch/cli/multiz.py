"""CLI mirroring the reference ``multiz`` executable (multiz.c:179-294) on
the port's DP backend.

args: [R=?] [M=?] [L=?] [S=?] file1 file2 v [out1 out2] [nohead] [all]

Same argv and output as ``multiz_tpu.cli.multiz``.
"""

from __future__ import annotations

import sys

from multiz_tpu import scores as sc
from multiz_tpu.cli.multiz import VERSION
from multiz_tpu.maf import read_maf, write_end, write_start
from multiz_tpu.multiz import MultizConfig, multiz

from ..ops.dispatch import default_batch_fn


def main(argv=None, out=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    out = out or sys.stdout
    cmd = f"multiz.v{VERSION}"
    args_line = cmd + " " + " ".join(argv) + " "

    cfg = MultizConfig(batch_fn=default_batch_fn())
    while argv and argv[0][:1] in "RMLS" and argv[0][1:2] == "=":
        key, val = argv[0][0], int(argv[0][2:])
        if val < 0:
            raise SystemExit(f"{cmd}: {key} cannot be negative")
        if key == "R":
            cfg.radius = val
        elif key == "M":
            cfg.min_output_wid = val
        elif key == "L":
            cfg.lrg_break_wid = val
        elif key == "S":
            cfg.sml_break_wid = val
        argv.pop(0)

    nohead = False
    if argv and argv[-1] == "all":
        cfg.row2 = 0
        argv.pop()
    if argv and argv[-1] == "nohead":
        nohead = True
        argv.pop()

    if len(argv) not in (3, 5):
        raise SystemExit(
            f"{cmd}: args: [R=?] [M=?] file1 file2 v? [out1 out2] "
            "[nohead] [all]"
        )

    out1 = out2 = None
    close = []
    if len(argv) == 5:
        out1 = open(argv[3], "w")
        out2 = open(argv[4], "w")
        close = [out1, out2]
    v = int(argv[2])
    if v not in (0, 1):
        raise SystemExit(f"{cmd}: v can only be value of 0, 1")

    if not nohead:
        write_start(out, "multiz")
        out.write(f"# {args_line}\n")
    sp = sc.init_scores70()

    # comment echo goes to `out` during parsing, like the C (maf.c:80-83)
    list1 = read_maf(argv[0], verbose=True, echo=out)
    list2 = read_maf(argv[1], verbose=True, echo=out)

    multiz(list1, list2, v, out, out1, out2, cfg=cfg, sp=sp)

    for fh in close:
        fh.close()
    # Quirk: with no out1/out2 the reference closes stdout before
    # mafWriteEnd, so the trailing ##eof is never emitted (multiz.c:287-292)
    if close:
        write_end(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
