"""Scoring parameters as the port's device operands.

``multiz_tpu.scores`` builds every scheme (HOX70/HOX85 substitution,
quasi-natural gap costs) as numpy arrays; the device stage needs only
the 6-category substitution matrix and the two gap costs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from multiz_tpu import scores as sc


@dataclass(frozen=True)
class ScoreTensors:
    ss_cat: torch.Tensor  # (6, 6) int32 on the device
    gap_open: int
    gap_extend: int


def from_score_params(sp: sc.ScoreParams | None, device) -> ScoreTensors:
    """``sp`` (default: the current scheme) -> device tensors and ints."""
    if sp is None:
        sp = sc.current
    ss_cat = torch.as_tensor(sp.ss_cat.astype("int32"), device=device)
    return ScoreTensors(
        ss_cat=ss_cat, gap_open=int(sp.gap_open), gap_extend=int(sp.gap_extend)
    )
