"""What the benchmark loads: no module whose top-level name, compared
whole, is jax, jaxlib, flax or immesh_tpu (the JAX package; its port
immesh_tpu_torch is another name), and a reference that loads nothing of
the program."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench.harness.cell import PERFBENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "immesh_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("part", ["harness", "sim", "entries", "metrics",
                                  "reference", "tools", "run.py"])
def test_no_source_imports_jax_or_the_jax_package(part):
    path = os.path.join(PERFBENCH, part)
    paths = [path] if path.endswith(".py") else list(_sources(path))
    assert paths
    for p in paths:
        bad = [m for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
        assert not bad, (p, bad)


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources(os.path.join(PERFBENCH, "reference")):
        bad = [m for m in _imports(p)
               if m.split(".")[0] == "immesh_tpu_torch"]
        assert not bad, (p, bad)


def test_a_run_loads_no_forbidden_module():
    """A whole run, on the CPU at a cut size, in a fresh interpreter: every
    module it loaded, the program's included, has an allowed top-level
    name, as run.py checks once the window has closed."""
    code = (
        "import sys, time\n"
        "from perfbench import run\n"
        "from perfbench.harness.window import run_cell\n"
        "from perfbench.tests.small import small_cell\n"
        "out = run_cell(small_cell('avia-indoor.orbit-room'), 5, 0.5, False,"
        " time.perf_counter(), device='cpu', setup_frames=3)\n"
        "assert out['result']['correct'] is True\n"
        "bad = run.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'immesh_tpu_torch' in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr
