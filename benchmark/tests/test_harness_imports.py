"""What the benchmark may import, by whole top-level module name; and the
run refuses to report without a card."""

import ast
import json
import shutil
import subprocess
import sys
import types

from benchmark import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "pressurepoissonsolver_tpu"}
PROGRAM = "pressurepoissonsolver_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (spec.HERE / sub).rglob("*.py")]


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        assert FORBIDDEN.isdisjoint(_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert PROGRAM not in set(_imports(path)), path
    code = ("import sys; import benchmark.reference.composite; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {PROGRAM})!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_are_found_by_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pressurepoissonsolver_tpu.solver",
                        types.ModuleType("pressurepoissonsolver_tpu.solver"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "pressurepoissonsolver_tpu"]


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "poisson2d-amr.ir", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark")
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    json.loads((tmp_path / "BENCHMARK.json").read_text())
