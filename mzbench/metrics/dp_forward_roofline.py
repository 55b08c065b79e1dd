"""dp_forward_roofline: the DP forward kernel (``csrc/yama_dp.cu``, both
paths) against the card's roofline, on the forward's own work: the
recurrence's operations for the band cells of the jobs it ran in the
window, the jobs' texts and bands read and its three two-bit choices a
cell written (``mzbench/work.py``), over its time in the device trace,
in %."""

from mzbench import work

KERNELS = ("yama_dp_warp", "yama_dp_block")


def read(run):
    if run.trace is None or run.hooks is None:
        return None
    jobs = [j for launch in run.hooks.launched for j in launch]
    if not jobs:
        return None
    ops, nbytes = work.forward_work(jobs)
    return work.roofline_pct(ops, nbytes, run.trace.kernel_s(KERNELS),
                             run.peaks)
