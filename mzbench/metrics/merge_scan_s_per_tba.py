"""merge_scan_s_per_tba: seconds a tba spends in the merge scan's own
work (``multiz.py``, ``blocks.py``), outside the DP stream and pre_yama:
the self time of the program's spans ``multiz``, ``multiz.scan`` and
``multiz.dp``, over the tbas."""

from mzbench.progtrace import self_s_per_tba


def read(run):
    return self_s_per_tba(run, ("multiz", "multiz.scan", "multiz.dp"))
