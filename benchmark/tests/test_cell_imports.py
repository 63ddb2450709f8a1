"""No module the benchmark runs is JAX or the JAX package, and the
reference imports nothing of the program either."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark.harness import runner
from benchmark.harness.spec import HERE, ROOT

JAXISH = {"jax", "jaxlib", "flax", "siril_tpu"}


def _top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


@pytest.mark.parametrize("folder", ["harness", "gen", "reference",
                                    "outputs", "metrics", "."])
def test_sources_import_no_jax(folder):
    for path in glob.glob(os.path.join(HERE, folder, "*.py")):
        assert not set(_top_imports(path)) & JAXISH, path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        assert "siril_tpu_torch" not in set(_top_imports(path)), path
    mods = _loaded_after(
        "import benchmark.reference.check_deepsky, "
        "benchmark.reference.deepsky, benchmark.reference.fitsread")
    assert "siril_tpu_torch" not in mods and not mods & JAXISH


def test_a_run_loads_no_jax():
    """What a run imports: the harness, the generators, the references,
    every metric reader and the program's entry with the commands."""
    mods = _loaded_after(
        "import benchmark.run\n"
        "from benchmark.harness import runner, trace, spec\n"
        "import benchmark.gen.deepsky\n"
        "import benchmark.reference.check_deepsky\n"
        "from benchmark.harness.spec import load_cell, load_json, ROOT\n"
        "import os\n"
        "b = load_json(os.path.join(ROOT, 'BENCHMARK.json'))\n"
        "[load_cell(w['name']) for w in b['workloads']]\n"
        "from siril_tpu_torch import cli\n"
        "import siril_tpu_torch.pipeline, siril_tpu_torch.planetary.mpp\n")
    assert "siril_tpu_torch" in mods
    assert not mods & JAXISH, mods & JAXISH


def test_the_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "siril_tpu_torch_fake", object())
    assert "siril_tpu_torch_fake" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "siril_tpu.fake", object())
    assert "siril_tpu.fake" in runner.forbidden_modules()


def test_a_run_with_jax_loaded_prints_no_result(capsys):
    from benchmark import run

    code = run.report({"leaked": ["jax"], "checks": {}, "correct": True})
    assert code != 0
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    a run exits with a code other than 0 and prints nothing."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "deepsky_mono_imx571.lights24", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
