"""merge_scan_s_per_roast: seconds a roast spends in the merge scan's
own work (``multiz.py``, ``blocks.py``), outside the DP stream and
pre_yama: the self time of the program's spans ``multiz``,
``multiz.scan`` and ``multiz.dp``, over the roasts."""

from mzbench.roastspans import self_s_per_roast


def read(run):
    return self_s_per_roast(run, ("multiz", "multiz.scan", "multiz.dp"),
                            "multiz.scan")
