"""yama_kernels_roofline: the three kernels of the packed DP stream
(``csrc/yama_prep.cu``, ``yama_dp.cu``, ``yama_tb.cu``) against the card's
roofline: the least time the card needs for the work of the jobs they
ran in the window (``mzbench/work.py``: operations and bytes counted
from the jobs, not from the kernels), over their time in the device
trace, in %. A later kernel that takes their work adds its name here."""

from mzbench import work

KERNELS = ("prep_warps", "prep_cluster", "yama_dp_warp", "yama_dp_block",
           "yama_tb_kernel")


def read(run):
    if run.trace is None or run.hooks is None:
        return None
    jobs = [j for launch in run.hooks.launched for j in launch]
    if not jobs:
        return None
    ops, nbytes = work.dp_work(jobs)
    return work.roofline_pct(ops, nbytes, run.trace.kernel_s(KERNELS),
                             run.peaks)
