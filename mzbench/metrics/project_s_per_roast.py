"""project_s_per_roast: seconds a roast spends projecting blocksets onto
the reference (``maf_project.py``): the self time of the program's spans
``maf_project``, over the roasts."""

from mzbench.roastspans import self_s_per_roast


def read(run):
    return self_s_per_roast(run, ("maf_project",), "maf_project")
