"""host_cpu_s_per_op.tba: the process's CPU seconds (every thread, the
host's own clock of CPU time) per operation of the window. Beside the
operations' wall time it tells a slower host from more work: on a host
that runs slower, wall and CPU time grow together."""


def read(run):
    if not run.ops:
        return None
    return sum(o.cpu for o in run.ops) / len(run.ops)
