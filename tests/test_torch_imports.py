"""The port stands alone: no module of ``unicore_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, Flax, Optax or anything of the JAX package
``unicore_tpu``, nor ``ml_dtypes`` (JAX's numpy bf16 type: the port reads
bf16 arrays by their bits) — checked statically over the source, and dynamically by
importing the server entry point with those names blocked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "unicore_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((REPO / "unicore_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


_BLOCKER = r"""
import importlib.abc, importlib.util, pkgutil, sys
FORBIDDEN = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, Block())
import unicore_tpu_torch
import unicore_tpu_torch.cli.serve
for mod in pkgutil.walk_packages(unicore_tpu_torch.__path__, "unicore_tpu_torch."):
    importlib.import_module(mod.name)
leaked = [m for m in sys.modules if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
assert not leaked, leaked
print("ok")
"""


def test_serve_imports_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER % (FORBIDDEN,)],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-4000:]


#: the data-parallel modules, which must stand alone like the rest
DP_MODULES = ("unicore_tpu_torch/parallel/__init__.py", "unicore_tpu_torch/parallel/plan.py",
              "unicore_tpu_torch/parallel/groups.py", "unicore_tpu_torch/parallel/hierarchy.py",
              "unicore_tpu_torch/distributed/utils.py", "unicore_tpu_torch/tools/dp_pair.py")


@pytest.mark.parametrize("rel", DP_MODULES)
def test_data_parallel_modules_are_scanned(rel):
    """Each data-parallel module exists and is among the scanned files (a
    copy of what it needs of the JAX package, not an import of it)."""
    assert REPO / rel in _port_files()
    test_no_jax_imports_in_source(REPO / rel)


#: the logging and telemetry modules of the training side
TELEMETRY_MODULES = (
    "unicore_tpu_torch/logging/meters.py", "unicore_tpu_torch/logging/metrics.py",
    "unicore_tpu_torch/logging/progress_bar.py", "unicore_tpu_torch/telemetry/__init__.py",
    "unicore_tpu_torch/telemetry/spans.py", "unicore_tpu_torch/telemetry/profiler.py",
    "unicore_tpu_torch/telemetry/prometheus.py", "unicore_tpu_torch/telemetry/trace.py",
    "unicore_tpu_torch/cli/trace.py")


@pytest.mark.parametrize("rel", TELEMETRY_MODULES)
def test_telemetry_modules_are_scanned(rel):
    """Each logging and telemetry module exists and is among the scanned
    files (its own copy of what it needs of the JAX package)."""
    assert REPO / rel in _port_files()
    test_no_jax_imports_in_source(REPO / rel)
