"""maf_read_s_per_tba: seconds a tba spends parsing its pairwise MAF
files (``maf.read_maf``): the self time of the program's spans
``maf.read``, over the tbas."""

from mzbench.progtrace import self_s_per_tba


def read(run):
    return self_s_per_tba(run, ("maf.read",))
