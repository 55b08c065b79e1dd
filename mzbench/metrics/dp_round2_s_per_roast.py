"""dp_round2_s_per_roast: seconds a roast spends in the DP rounds after
the first of its v == 0 ``multiz`` calls (the second DP of each job, one
blocking one-shot ``yama_batch_packed`` call a round, with no planning
left to hide it): the whole duration of the program's spans
``multiz.dp.round2`` (the stream's stages tick inside them), over the
roasts. None where the program records no such span."""

from mzbench.roastspans import span_s_per_roast


def read(run):
    return span_s_per_roast(run, "multiz.dp.round2")
