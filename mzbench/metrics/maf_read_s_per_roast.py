"""maf_read_s_per_roast: seconds a roast spends parsing its pairwise MAF
files (``maf.read_maf``): the self time of the program's spans
``maf.read``, over the roasts."""

from mzbench.roastspans import self_s_per_roast


def read(run):
    return self_s_per_roast(run, ("maf.read",), "maf.read")
