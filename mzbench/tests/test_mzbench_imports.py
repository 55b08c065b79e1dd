"""Nothing the benchmark runs is JAX or the JAX package, and its
reference, generators and frozen copies import nothing of the program.
Top-level names are compared whole: ``multiz_tpu_torch`` begins with
``multiz_tpu``."""

import ast
import os
import subprocess
import sys
import textwrap

from mzbench import harness

HERE = harness.HERE
NEVER = {"jax", "jaxlib", "flax", "multiz_tpu"}
PROGRAM = "multiz_tpu_torch"
# the reference and the inputs: no module of the program
STANDALONE = ("reference", "frozen", "traffic", "work.py", "rates.py",
              "devtrace.py", "peaks.py")


def sources(*parts):
    for part in parts or ("",):
        root = os.path.join(HERE, part)
        if root.endswith(".py"):
            yield root
            continue
        for d, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(top_names(path)) & NEVER, path


def test_reference_and_inputs_import_nothing_of_the_program():
    for path in sources(*STANDALONE):
        assert PROGRAM not in set(top_names(path)), path


def run_py(code):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip().splitlines()[-1].split(",")


def test_reference_and_generators_load_nothing_of_the_program(tmp_path):
    loaded = run_py(f"""
        import json, sys
        from mzbench.traffic import tba_region, dp_pool
        from mzbench.reference import tba, dp
        conf = json.load(open("mzbench/configs/encode_5sp.json"))
        ds = tba_region.make(conf, 6000, 5, 1, {str(tmp_path)!r})
        tba.maf(ds)
        mix = json.load(open("mzbench/traffic/dp_batches.json"))
        dp.yama_batch(dp_pool.make(dict(mix, pool_jobs=8), 5))
        print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert not set(loaded) & (NEVER | {PROGRAM})


def test_a_run_loads_no_jax(tmp_path):
    loaded = run_py(f"""
        import sys
        from mzbench import cache, harness
        cache.DIR = {str(tmp_path)!r}
        files = harness.cell_files("encode_5sp.tba_2mb")
        files["mix"].update(region_bases=6000)
        line = harness.run_cell("encode_5sp.tba_2mb", 3, 0.2, False, "cpu",
                                files=files)
        assert line["correct"], line
        print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert PROGRAM in loaded
    assert not set(loaded) & NEVER


def test_without_a_card_the_measured_path_fails():
    res = subprocess.run(
        [sys.executable, "-m", "mzbench", "--workload", "encode_5sp.tba_2mb",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"correct"' not in res.stdout


def test_alone_with_its_manifest_the_benchmark_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "mzbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    res = subprocess.run(
        [sys.executable, "-m", "mzbench", "--workload", "encode_5sp.tba_2mb",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"correct"' not in res.stdout
