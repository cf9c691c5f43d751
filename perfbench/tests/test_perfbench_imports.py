"""Nothing the harness runs loads JAX or the JAX package; the reference
imports nothing of the program."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
# one thread per test process: the tests run in several workers at once
torch.set_num_threads(1)
FORBIDDEN = {"jax", "jaxlib", "flax", "pgdvs_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    assert not {m.split(".")[0] for m in _imports(path)} & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT / "perfbench" / "reference")))
def test_reference_imports_nothing_of_the_program(path):
    assert all(m.split(".")[0] != "pgdvs_tpu_torch" for m in _imports(path))


def test_a_run_loads_no_jax():
    """A CPU rehearsal of a cell in a fresh interpreter: no module whose
    top-level name is JAX's or the JAX package's is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench.harness.bench import load_json, run_cell\n"
        "b = load_json(%r)\n"
        "run_cell(b, 'default_fast.nvidia', 3, 0.1, True, device='cpu', overrides="
        "{'config': {'hw': [24, 32], 'n_spatial': 3, 'n_coarse_samples': 8},"
        " 'traffic': {'n_frames': 6, 'n_targets': 2, 'rays_checked_per_view': 16}})\n"
        "import perfbench.run as r\n"
        "print(sorted(r.loaded_forbidden()))\n" % (str(ROOT), str(ROOT / "BENCHMARK.json")))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
