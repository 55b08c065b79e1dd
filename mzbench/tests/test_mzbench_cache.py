"""A seed's reference answer is worked out once and then read back;
a changed configuration or mix never meets an old answer."""

import os

from mzbench import cache


class Ctx:
    def __init__(self, seed, mix):
        self.cell, self.config, self.mix = {"name": "c.t"}, {"a": 1}, mix
        self.seed = seed


def test_worked_out_once_then_read_back():
    made = []

    def make():
        made.append(1)
        return "a score=1\ns x 0 1 + 1 A\n"

    p = cache.path(Ctx(2**40 + 3, {"n": 1}), "ref.maf.gz")
    assert cache.text(p, make) == (make(), False)
    assert cache.text(p, make) == (make(), True)
    assert len(made) == 3  # twice by hand, once by the first call
    assert not [f for f in os.listdir(os.path.dirname(p)) if ".part" in f]


def test_the_key_follows_seed_and_files():
    a = cache.path(Ctx(5, {"n": 1}), "x")
    assert a == cache.path(Ctx(5, {"n": 1}), "x")
    assert a != cache.path(Ctx(6, {"n": 1}), "x")
    assert a != cache.path(Ctx(5, {"n": 2}), "x")
    assert a.startswith(cache.DIR)
