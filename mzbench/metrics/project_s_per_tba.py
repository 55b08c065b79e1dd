"""project_s_per_tba: seconds a tba spends projecting blocksets
(``maf_project.py``): the self time of the program's spans
``maf_project``, over the tbas."""

from mzbench.progtrace import self_s_per_tba


def read(run):
    return self_s_per_tba(run, ("maf_project",))
