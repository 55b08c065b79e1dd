"""stream_host_us_per_job.tba: the DP stream's host stages, as it times
them itself (``MZ_TIME``: ``pack`` + ``dispatch`` + ``replay``), summed
over the window, in microseconds per job it sent to the card
(``route_stats["device_jobs"]``)."""

from mzbench.hooks import stream_us_per_job


def read(run):
    return stream_us_per_job(run)
