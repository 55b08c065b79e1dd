"""The port stands on its own: no module of ``multiz_tpu_torch``, and
neither ``chip_smoke.py`` nor the card's perf guard
(``tests/test_torch_perf_guard.py``), imports the JAX package or jax (read
from the source with ``ast``), and the port's copies of the JAX
package's host layer give the same answers as their originals.

Inputs are made from a seed with numpy (or written as files by both
simulators) and handed to both packages as arrays, paths or text,
never as objects: an ``Ali`` of one package is not one of the other,
and each package keeps its own current scoring scheme. Every
comparison is exact.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from multiz_tpu import scores as jsc
from multiz_tpu import yama as JY
from multiz_tpu.cli import single_cov2 as jsc2
from multiz_tpu.maf import format_ali as jformat
from multiz_tpu.multiz import MultizConfig as JCfg
from multiz_tpu.ops.synth import synth_jobs as jsynth
from multiz_tpu.tree import roast_run as jroast, tba_run as jtba
from multiz_tpu_torch import scores as tsc
from multiz_tpu_torch import yama as TY
from multiz_tpu_torch.cli import single_cov2 as tsc2
from multiz_tpu_torch.maf import format_ali as tformat
from multiz_tpu_torch.multiz import MultizConfig as TCfg
from multiz_tpu_torch.ops.synth import synth_jobs as tsynth
from multiz_tpu_torch.tree import roast_run as troast, tba_run as ttba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "multiz_tpu_torch", "**", "*.py"),
              recursive=True)
) + ["chip_smoke.py", "tests/test_torch_perf_guard.py"]


def _foreign_imports(path):
    """(line, module) of every import of jax or the JAX package."""
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in ("multiz_tpu", "jax", "jaxlib")]
    return bad


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_neither_jax_nor_the_jax_package(path):
    assert _foreign_imports(path) == []


def test_the_import_scan_sees_what_it_refuses(tmp_path):
    """The scan above finds each import form it must refuse."""
    src = ("import multiz_tpu\nimport jax.numpy as jnp\n"
           "from multiz_tpu.yama import yama_numpy\n"
           "def f():\n    from multiz_tpu import scores\n"
           "from multiz_tpu_torch import yama\nfrom . import maf\n")
    p = tmp_path / "probe.py"
    p.write_text(src)
    assert [n for _, n in _foreign_imports(str(p))] == [
        "multiz_tpu", "jax.numpy", "multiz_tpu.yama", "multiz_tpu"]


def test_native_runtime_is_the_ports_own():
    mz = TY._mzcore
    assert mz.__name__ == "multiz_tpu_torch._mzcore"
    assert os.path.dirname(mz.__file__) == os.path.join(
        ROOT, "multiz_tpu_torch", "_build")
    if JY._mzcore is not None:
        assert mz is not JY._mzcore and mz.__file__ != JY._mzcore.__file__


@pytest.mark.parametrize("ref", ["jax-native", "jax-numpy"])
def test_yama_numpy_matches_the_jax_package(ref, monkeypatch):
    """The port's exact DP (its native runtime) against the JAX
    package's, native or pure numpy, over jobs from one numpy seed."""
    if ref == "jax-numpy":
        monkeypatch.setattr(JY, "_mzcore", None)
    jobs = jsynth(12, m_lo=16, m_hi=120, k_lo=1, k_hi=5, radius=12, seed=17)
    tjobs = tsynth(12, m_lo=16, m_hi=120, k_lo=1, k_hi=5, radius=12,
                   seed=17)
    for i, (job, tjob) in enumerate(zip(jobs, tjobs)):
        for a, b in zip(job, tjob):
            np.testing.assert_array_equal(a, b, err_msg=f"job {i} input")
        np.testing.assert_array_equal(TY.yama_numpy(*tjob),
                                      JY.yama_numpy(*job), err_msg=f"job {i}")


@pytest.mark.parametrize("ref", ["jax-native", "jax-numpy"])
def test_yama_numpy_of_an_empty_a_matches_the_jax_package(ref, monkeypatch):
    """M == 0 on the port's one path: an empty A merges with an empty B
    into no columns, and with a non-empty B the traceback walks off the
    matrix, a YamaError in both packages."""
    if ref == "jax-numpy":
        monkeypatch.setattr(JY, "_mzcore", None)
    A = np.empty((0, 2), np.uint8)
    for N in (0, 1, 12):
        B = np.frombuffer(b"ACGT-" * 8, np.uint8)[: N * 3].reshape(N, 3)
        LB, RB = np.zeros(1, np.int64), np.full(1, N, np.int64)
        try:
            want = JY.yama_numpy(A, B, LB, RB)
        except JY.YamaError:
            with pytest.raises(TY.YamaError):
                TY.yama_numpy(A, B, LB, RB)
            assert N > 0
            continue
        assert N == 0
        np.testing.assert_array_equal(TY.yama_numpy(A, B, LB, RB), want)
        assert want.shape == (0, 5)


def test_native_yama_many_and_replay_match_the_jax_package():
    """``yama_many`` and ``replay_into`` of both native runtimes, called
    with the same numpy buffers."""
    if JY._mzcore is None:
        pytest.skip("the JAX package's native runtime did not build")
    jobs = jsynth(8, m_lo=20, m_hi=90, k_lo=1, k_hi=4, radius=10, seed=23)
    sp = jsc.current

    def many(mz):
        probs, outs = [], []
        for A, B, LB, RB in jobs:
            (M, K), (N, L) = A.shape, B.shape
            out = np.zeros((M + N, K + L), dtype=np.uint8)
            probs.append((A, M, K, B, N, L, np.ascontiguousarray(LB),
                          np.ascontiguousarray(RB), out))
            outs.append(out)
        nedits = mz.yama_many(probs, sp.ss_cat, jsc.BYTE2CAT,
                              int(sp.gap_open), int(sp.gap_extend))
        return list(nedits), outs

    tn, touts = many(TY._mzcore)
    jn, jouts = many(JY._mzcore)
    assert tn == jn
    for i, (t, j) in enumerate(zip(touts, jouts)):
        np.testing.assert_array_equal(t, j, err_msg=f"job {i}")
    rng = np.random.default_rng(5)
    A = rng.choice(np.frombuffer(b"ACGT-", np.uint8), size=(6, 2))
    B = rng.choice(np.frombuffer(b"ACGT-", np.uint8), size=(5, 3))
    script = np.array([0, 2, 0, 1, 0, 2, 0], dtype=np.uint8)  # 6 + 5
    res = []
    for mz in (TY._mzcore, JY._mzcore):
        out = np.zeros((len(script), 5), dtype=np.uint8)
        mz.replay_into(script, len(script), True, A, 6, 2, B, 5, 3, out)
        res.append(out)
    np.testing.assert_array_equal(*res)


@pytest.fixture(scope="module")
def sim_dirs(tmp_path_factory):
    """tests/sim.py and the port's tools/sim.py at 20 kb x 4 species,
    seed 9, each followed by its own package's single_cov2."""
    from tests import sim as jsim

    from multiz_tpu_torch.tools import sim as tsim

    dirs = {}
    for name, mod, cov in (("jax", jsim, jsc2), ("port", tsim, tsc2)):
        d = str(tmp_path_factory.mktemp(f"sim_{name}"))
        cfg = mod.SimConfig(seed=9)
        mod.simulate(cfg, d)
        cwd = os.getcwd()
        os.chdir(d)  # single_cov2 echoes its argv into the file
        try:
            for s in cfg.species:
                with open(f"human.{s}.sing.maf", "w") as fh:
                    cov.main([f"human.{s}.orig.maf"], out=fh)
        finally:
            os.chdir(cwd)
        dirs[name] = (d, cfg.species)
    return dirs


def test_sim_copy_writes_the_same_files(sim_dirs):
    (jd, species), (td, _) = sim_dirs["jax"], sim_dirs["port"]
    names = sorted(os.listdir(jd))
    assert len(species) == 3 and names == sorted(os.listdir(td))
    assert len([n for n in names if n.endswith(".orig.maf")]) == 3
    for n in names:
        with open(os.path.join(jd, n), "rb") as a, \
                open(os.path.join(td, n), "rb") as b:
            assert a.read() == b.read(), n


@pytest.mark.parametrize("tool", ["tba", "roast"])
def test_tba_and_roast_match_the_jax_package(tool, sim_dirs):
    """Both packages' tba_run / roast_run inline on the host over the
    simulated dataset: the rendered MAF is byte-equal."""
    d, species = sim_dirs["port"]
    tree = "human"
    for s in species:
        tree = f"({tree} {s})"
    pairs = [f"human.{s}.sing.maf" for s in species]
    if tool == "tba":
        want = jtba(tree, pairs, src_dir=d, cfg=JCfg(),
                    sp=jsc.init_scores70())
        got = ttba(tree, pairs, src_dir=d, cfg=TCfg(),
                   sp=tsc.init_scores70())
    else:
        want = jroast("human", tree, pairs, src_dir=d, cfg=JCfg(),
                      sp=jsc.init_scores70())
        got = troast("human", tree, pairs, src_dir=d, cfg=TCfg(),
                     sp=tsc.init_scores70())
    assert len(want) > 10
    assert "".join(tformat(a) for a in got) == "".join(jformat(a)
                                                      for a in want)


def test_auto_dispatch_needs_a_card(monkeypatch):
    """``auto`` (the default) is the packed kernels on a card and raises
    without one, naming the explicit host modes."""
    from multiz_tpu_torch.ops import dispatch

    monkeypatch.delenv("MULTIZ_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none, host, packed-cpu or "
                                           "full-cpu"):
        dispatch.default_batch_fn()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fn = dispatch.default_batch_fn()
    assert fn.device == torch.device("cuda")
    for mode, want in (("none", None), ("host", dispatch.host_batch)):
        monkeypatch.setenv("MULTIZ_TPU_TORCH_DEVICE", mode)
        assert dispatch.default_batch_fn() is want
    monkeypatch.setenv("MULTIZ_TPU_TORCH_DEVICE", "packed-cpu")
    assert dispatch.default_batch_fn().device == torch.device("cpu")


@pytest.mark.parametrize("argv", [[], ["dryrun", "2"]], ids=["entry", "dryrun"])
def test_entry_main_needs_a_card(argv, monkeypatch):
    from multiz_tpu_torch import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(argv)
