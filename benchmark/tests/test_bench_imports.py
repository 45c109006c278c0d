"""Nothing the benchmark runs imports JAX or the JAX package: no import in
its sources names them (top-level names compared whole, so
`talkshow_torch` is not `talkshow_tpu`), the reference imports nothing of
the program, and a run's process holds none of them at its end."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness

SOURCES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax():
    assert SOURCES
    for path in SOURCES:
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        assert not _imports(path) & {"talkshow_torch", *harness.FORBIDDEN}, path


def test_whole_name_comparison():
    saved = dict(sys.modules)
    try:
        sys.modules["talkshow_tpu_extra"] = sys
        sys.modules["jaxlib.xla"] = sys
        assert harness.forbidden_loaded() == ["jaxlib"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_none(tmp_path):
    code = ("import pathlib, sys\n"
            "from benchmark import harness\n"
            "from benchmark.tests import toy\n"
            f"root = pathlib.Path({str(tmp_path)!r})\n"
            "toy.make_tree(root)\n"
            "harness.execute(toy.spec(root, 'toy-gen'), 3, 0.5, False, 'cpu')\n"
            "print(harness.forbidden_loaded())\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
