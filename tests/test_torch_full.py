"""The port's full-row DP (multiz_tpu_torch/ops/yama_full.py) on the CPU
against the JAX package's full-row path (multiz_tpu/ops/yama_jax.py,
jitted on the CPU), the oracle and the fuzz fixtures; its mesh
sharding; its entry step against __graft_entry__.entry; and the packed
stream's MZ_TIME / MZ_COUNT_FALLBACK diagnostics.

Every comparison is exact (tolerance 0): the DP is integer arithmetic.
Inputs are made from a seed with numpy and go unchanged to both
packages.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiz_tpu import scores as sc
from multiz_tpu import yama as Y
from multiz_tpu.ops import yama_jax as YJ
from multiz_tpu.ops.synth import synth_block, synth_jobs
from multiz_tpu_torch.ops import yama_full as F
from multiz_tpu_torch.ops import yama_pack as P
from multiz_tpu_torch.parallel.sharding import make_mesh, shard_stacked

from .conftest import GOLDEN

# one non-square bucket: M 30..56 fits 64 rows, N up to 63 columns
M_PAD, N_PAD = 64, 128


def _bucket_jobs():
    return synth_jobs(7, m_lo=30, m_hi=56, k_lo=1, k_hi=4, radius=12,
                      seed=21)


def _jax_stacked():
    return {k: np.asarray(v) for k, v in
            YJ.stack_jobs(_bucket_jobs(), M_PAD, N_PAD).items()}


@functools.lru_cache(maxsize=None)
def _jax_forward():
    """JAX _yama_core (vmapped, jitted on the CPU) and _traceback_core
    on the bucket: (flags, lastC, lastD, lastI, script, nedit)."""
    sp = sc.current
    ss = jnp.asarray(sp.ss_cat)
    go, ge = int(sp.gap_open), int(sp.gap_extend)
    core = functools.partial(YJ._yama_core, ss_cat=ss, go=go, ge=ge,
                             m_pad=M_PAD, n_pad=N_PAD)
    stacked = _jax_stacked()
    flags, lc, ld, li = jax.jit(jax.vmap(core))(
        *(stacked[k] for k in YJ.STACK_KEYS))
    tb = functools.partial(YJ._traceback_core, m_pad=M_PAD, n_pad=N_PAD)
    script, nedit = jax.jit(jax.vmap(tb))(
        flags, stacked["LB"], stacked["RB"], stacked["M"], stacked["N"],
        lc, ld, li)
    return tuple(np.array(x) for x in (flags, lc, ld, li, script, nedit))


def _port_stacked():
    return F.stack_jobs(_bucket_jobs(), M_PAD, N_PAD, "cpu")


@pytest.mark.parametrize("ref", ["jax-native", "jax-numpy"])
def test_stack_jobs_matches_jax(ref, monkeypatch):
    """The port's stack (native column statistics) against the JAX
    package's, built by its native runtime or by its numpy."""
    if ref == "jax-numpy":
        monkeypatch.setattr(Y, "_mzcore", None)
        monkeypatch.setattr(YJ, "_mzcore", None)
    elif Y._mzcore is None:
        pytest.skip("the JAX package's native runtime did not build")
    got = _port_stacked()
    want = _jax_stacked()
    assert tuple(got) == F.STACK_KEYS == YJ.STACK_KEYS
    for k in F.STACK_KEYS:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_yama_core_matches_jax():
    sp = sc.current
    st = _port_stacked()
    flags, lc, ld, li = F.yama_core(
        *(st[k] for k in F.STACK_KEYS), torch.as_tensor(sp.ss_cat),
        int(sp.gap_open), int(sp.gap_extend), M_PAD, N_PAD,
    )
    jflags, jlc, jld, jli = _jax_forward()[:4]
    assert flags.dtype == torch.uint8
    assert flags.shape == (7, M_PAD + 1, N_PAD + 1)
    np.testing.assert_array_equal(flags.numpy(), jflags)
    for got, want in zip((lc, ld, li), (jlc, jld, jli)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_traceback_core_matches_jax():
    """Both tracebacks walk the same (JAX) flag matrix."""
    jflags, jlc, jld, jli, jscript, jnedit = _jax_forward()
    st = _port_stacked()
    script, nedit = F.traceback_core(
        torch.from_numpy(jflags), st["LB"], st["RB"], st["M"], st["N"],
        *(torch.from_numpy(x) for x in (jlc, jld, jli)), M_PAD, N_PAD,
    )
    np.testing.assert_array_equal(script.numpy(), jscript)
    np.testing.assert_array_equal(nedit.numpy(), jnedit)


def test_yama_batch_matches_jax_and_oracle():
    """tests/test_yama_jax.py's workload (several buckets)."""
    jobs = synth_jobs(24, m_lo=16, m_hi=200, k_lo=1, k_hi=5, radius=12,
                      seed=11)
    got = F.yama_batch(jobs, device="cpu")
    ref = YJ.yama_batch(jobs)
    for i, (job, out, jout) in enumerate(zip(jobs, got, ref)):
        np.testing.assert_array_equal(out, Y.yama_numpy(*job),
                                      err_msg=f"job {i}")
        np.testing.assert_array_equal(out, jout, err_msg=f"job {i} (JAX)")


def test_yama_full_matches_reference_fixtures():
    data = np.load(os.path.join(GOLDEN, "yama_fuzz.npz"))
    for i in range(int(data["n_cases"])):
        got = F.yama_full(*(data[f"case{i}_{k}"] for k in "A B LB RB".split()),
                          device="cpu")
        np.testing.assert_array_equal(got, data[f"case{i}_out"],
                                      err_msg=f"case {i}")


def test_yama_batch_on_a_mesh_matches_oracle(caplog):
    """Odd bucket sizes are padded to the mesh; one device listed twice
    is logged."""
    jobs = synth_jobs(10, m_lo=16, m_hi=64, radius=8, seed=5)
    mesh = make_mesh(["cpu"] * 2)
    assert "shards share a device" in caplog.text
    got = F.yama_batch(jobs, mesh=mesh)
    for i, (job, out) in enumerate(zip(jobs, got)):
        np.testing.assert_array_equal(out, Y.yama_numpy(*job),
                                      err_msg=f"job {i}")


def test_mesh_refuses_what_it_does_not_port(monkeypatch):
    with pytest.raises(ValueError, match="must divide device count 3"):
        make_mesh(["cpu"] * 3, band=2)
    with pytest.raises(ValueError, match="pad_batch"):
        shard_stacked({"M": torch.zeros(3)}, make_mesh(["cpu"] * 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_full_mode_without_a_card_raises(monkeypatch):
    """MULTIZ_TPU_TORCH_DEVICE=full never runs on the CPU in the card's
    place; full-cpu is the CPU mode."""
    from multiz_tpu_torch.ops import dispatch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MULTIZ_TPU_TORCH_DEVICE", "full")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.default_batch_fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.yama_batch(synth_jobs(1, m_lo=16, m_hi=20, seed=1))
    monkeypatch.setenv("MULTIZ_TPU_TORCH_DEVICE", "full-cpu")
    assert dispatch.default_batch_fn().device == torch.device("cpu")
    monkeypatch.setenv("MULTIZ_TPU_TORCH_DEVICE", "full-gpu")
    with pytest.raises(ValueError, match="unknown mode"):
        dispatch.default_batch_fn()


def test_entry_step_matches_graft_entry():
    """entry() runs the same batched step as __graft_entry__.entry()."""
    import __graft_entry__ as GE
    from multiz_tpu_torch.entry import entry

    fn, args = entry("cpu")
    scripts, nedits = fn(*args)
    jfn, jargs = GE.entry()
    jscripts, jnedits = jax.jit(jfn)(*jargs)
    assert tuple(scripts.shape) == (8, 512)
    np.testing.assert_array_equal(scripts.numpy(), np.asarray(jscripts))
    np.testing.assert_array_equal(nedits.numpy(), np.asarray(jnedits))


def _diag_jobs():
    """Small jobs (host lane below 600 cells), larger ones (a device
    bucket) and one band wider than any window (the oracle)."""
    rng = np.random.default_rng(4)
    M, N = 40, 1100
    wide = (synth_block(rng, M, 1), synth_block(rng, N, 1),
            np.zeros(M + 1, np.int64), np.full(M + 1, N, np.int64))
    return (synth_jobs(5, m_lo=16, m_hi=24, radius=8, seed=41)
            + synth_jobs(4, m_lo=60, m_hi=80, radius=8, seed=42) + [wide])


MZ_TIME_KEYS = {"pack", "dispatch", "device-sync", "d2h", "launches",
                "replay", "lane-wait", "lane-busy", "jobs", "cells"}


def test_stream_prints_mz_time_and_fallback(monkeypatch, capsys):
    """The JAX stream's [MZ_TIME] keys and its [MZ_FALLBACK] line, and
    nothing when the variables are unset."""
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "600")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    jobs = _diag_jobs()
    want = [Y.yama_numpy(*j) for j in jobs]

    def run():
        st = P.PackedDPStream(device="cpu", autoflush=False)
        for j in jobs:
            st.submit(j)
        got = st.finish()
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"job {i}")
        return st.stats, capsys.readouterr().out

    stats, out = run()
    assert "[MZ_" not in out
    assert stats["host_jobs"] and stats["device_jobs"]
    assert stats["fallback_jobs"] == 1

    monkeypatch.setenv("MZ_TIME", "1")
    monkeypatch.setenv("MZ_COUNT_FALLBACK", "1")
    _, out = run()
    lines = out.splitlines()
    keys = set()
    for l in lines:
        if l.startswith("[MZ_TIME] "):
            keys |= set(re.findall(r"([\w-]+)=", l))
    assert keys == MZ_TIME_KEYS, out
    fb = [l for l in lines if l.startswith("[MZ_FALLBACK] ")]
    assert len(fb) == 1 and fb[0].startswith(
        f"[MZ_FALLBACK] jobs=1/{len(jobs)} cells="), out
    (sizes,) = re.findall(r"launches=\[([\d, ]+)\]", out)
    assert sum(int(x) for x in sizes.split(",")) == 4, out
    assert "d2h=0.0000" in out  # the CPU payload needs no copy
