"""maf_render_s_per_tba: seconds a tba's blocks take to render as MAF
text (``maf.format_ali``, with the blocks' deferred scores): the
program's timed counter ``maf.format``, over the tbas."""

from mzbench.progtrace import counter_s_per_tba


def read(run):
    return counter_s_per_tba(run, ("maf.format",))
