"""Pipeline goldens through the port on the CPU, every DP job forced onto
the port's device stream (its plain kernel versions on the CPU), and a
check that the port runs a whole tba without importing jax.

Comparison ignores '#' lines, as tests/test_tree.py does; the multiz
goldens are byte-equal except for the argv echo line.
"""

import io
import os
import subprocess
import sys

import pytest

from multiz_tpu_torch.cli import multiz as mz_cli
from multiz_tpu_torch.cli import roast as roast_cli
from multiz_tpu_torch.cli import tba as tba_cli
from multiz_tpu_torch.ops import yama_pack as P

from .conftest import GOLDEN

DATA = os.path.join(GOLDEN, "data")
EXPECT = os.path.join(GOLDEN, "expect")
ROOT = os.path.dirname(os.path.dirname(GOLDEN))
TREE4 = "(((human chimp) mouse) rat)"
PAIRS4 = ["human.chimp.sing.maf", "human.mouse.sing.maf",
          "human.rat.sing.maf"]


def _expect(name):
    with open(os.path.join(EXPECT, name)) as fh:
        return fh.read()


def _block_lines(text):
    return [l for l in text.split("\n") if l and not l.startswith("#")]


@pytest.mark.parametrize("golden", ["multiz_v0", "multiz_v1", "tba4",
                                    "roast4"])
def test_golden_through_port_device_path(golden, monkeypatch, tmp_path):
    monkeypatch.setenv("MULTIZ_TPU_TORCH_DEVICE", "packed-cpu")
    monkeypatch.setenv("MZ_HOST_JOB_CELLS", "0")
    monkeypatch.setenv("MZ_HOST_ROUTE_CELLS", "0")
    P.reset_route_stats()
    if golden.startswith("multiz"):
        v = golden[-1]
        out = io.StringIO()
        mz_cli.main([os.path.join(DATA, "human.chimp.sing.maf"),
                     os.path.join(DATA, "human.mouse.sing.maf"), v], out=out)
        got = [l for l in out.getvalue().split("\n")
               if not l.startswith("# multiz.v")]
        want = [l for l in _expect(f"{golden}.maf").split("\n")
                if not l.startswith("# multiz.v")]
        assert got == want
    else:
        dest = str(tmp_path / f"{golden}.maf")
        monkeypatch.chdir(DATA)
        if golden == "tba4":
            tba_cli.main([TREE4, *PAIRS4, dest])
        else:
            roast_cli.main(["E=human", TREE4, *PAIRS4, dest])
        with open(dest) as fh:
            assert _block_lines(fh.read()) == _block_lines(
                _expect(f"{golden}.maf"))
    assert P.route_stats["device_jobs"] > 0
    assert P.route_stats["host_jobs"] == 0


def test_port_tba_never_imports_jax(tmp_path):
    """A fresh interpreter imports the port and runs its tba CLI on the
    golden data through the port's stream; jax stays unimported."""
    dest = str(tmp_path / "tba.maf")
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import multiz_tpu_torch\n"
        "from multiz_tpu_torch.cli import tba\n"
        f"os.chdir({DATA!r})\n"
        f"tba.main(['((human chimp) mouse)', 'human.chimp.sing.maf', "
        f"'human.mouse.sing.maf', {dest!r}])\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('no jax')\n"
    )
    env = dict(os.environ, MULTIZ_TPU_TORCH_DEVICE="packed-cpu",
               MZ_HOST_JOB_CELLS="0", MZ_HOST_ROUTE_CELLS="0")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "no jax" in res.stdout
    with open(dest) as fh:
        assert _block_lines(fh.read()) == _block_lines(_expect("tba.maf"))
