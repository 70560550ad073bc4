"""The port stands alone: no module of gecoz_tpu_torch, and not
chip_smoke.py, imports gecoz_tpu or JAX, at any depth.

Two checks: every `import`/`from ... import` node of every module (lazy
imports inside functions included) names neither package, and every port
module imports in a fresh interpreter whose import hook refuses both.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "gecoz_tpu_torch"
REFUSED = ("gecoz_tpu", "jax", "jaxlib")
# the package's modules; build/ holds what the package builds at run time
MODULES = sorted(p for p in PORT.rglob("*.py")
                 if p.relative_to(PORT).parts[0] != "build")
SOURCES = MODULES + [REPO / "chip_smoke.py"]


def _imported(tree) -> list[tuple[int, str]]:
    """(line, top-level package) of every absolute import in `tree`."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module.split(".")[0]))
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_reference_or_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, top) for line, top in _imported(tree) if top in REFUSED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_walk_sees_lazy_imports():
    tree = ast.parse(textwrap.dedent("""
        def f():
            from gecoz_tpu import native
            import jax.numpy as jnp
        """))
    assert [top for _, top in _imported(tree)] == ["gecoz_tpu", "jax"]


_IMPORT_ALL = textwrap.dedent("""
    import importlib
    import pkgutil
    import sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("gecoz_tpu", "jax", "jaxlib"):
                raise ImportError("refused: " + name)

    sys.meta_path.insert(0, Refuse())
    import gecoz_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(gecoz_tpu_torch.__path__,
                                                   "gecoz_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("gecoz_tpu", "jax", "jaxlib")]
    assert not loaded, loaded
    print("IMPORTED", len(names))
""")


def test_every_module_imports_with_both_refused(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split("IMPORTED")[1])
    assert count == len(MODULES) - 1                 # minus __init__


def test_the_walk_covers_the_parallel_modules():
    """The mesh route, the sharded sort and the dry run are among the
    modules both checks walk."""
    names = {str(p.relative_to(PORT)) for p in MODULES}
    assert {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharded_sa.py", "parallel/dryrun.py"} <= names
