"""maf_render_s_per_roast: seconds a roast's blocks take to render as MAF
text (``maf.format_ali``, with the blocks' deferred scores): the
program's timed counter ``maf.format``, over the roasts."""

from mzbench.roastspans import counter_s_per_roast


def read(run):
    return counter_s_per_roast(run, ("maf.format",))
