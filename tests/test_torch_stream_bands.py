"""The port's packed DP stream on band shapes that stress the windowing of
the JAX kernel: several row chunks with a moving window base, and a
band that needs the 512-lane window beside jobs at 256. Compared with
the oracle and the JAX stream in interpret mode (see torch_cases.py).
"""

import pytest

from .torch_cases import check_stream_case


@pytest.mark.parametrize("case", ["narrow_chunks", "ladder_512"])
def test_stream_bands_match_oracle_and_jax(case, monkeypatch):
    check_stream_case(case, monkeypatch)
