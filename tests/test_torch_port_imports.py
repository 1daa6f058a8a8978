"""The port imports no JAX and nothing of the JAX package.

The test process itself imports JAX (``tests/conftest.py``), so the check
runs in a fresh interpreter: import every module of ``im2im_uq_tpu_torch``
and ``chip_smoke``, then assert that none of ``jax``, ``flax``, ``grain``
(whose import loads JAX) and ``im2im_uq_tpu`` was loaded. Statically, no ``import`` or ``from`` in the
port's sources or in ``chip_smoke.py``, at any depth, names one of them (nor
grain: the port's ``data/grain_pipeline.py`` rebuilds its order): the
port keeps its own copies of the host code it shares with the JAX package.
"""

from __future__ import annotations

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import im2im_uq_tpu_torch

REPO = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in ("jax", "flax", "grain", "im2im_uq_tpu") if m in sys.modules)
assert not leaked, leaked
print("ok", len(sys.argv) - 1)
"""


def _port_modules() -> list[str]:
    names = [im2im_uq_tpu_torch.__name__]
    for info in pkgutil.walk_packages(im2im_uq_tpu_torch.__path__, prefix="im2im_uq_tpu_torch."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_no_jax():
    modules = _port_modules() + ["chip_smoke"]
    assert len(modules) > 15
    assert {f"im2im_uq_tpu_torch.scripts.{m}" for m in (
        "calibrate", "export_serving", "infer", "router", "sweep", "export_torch",
        "import_torch", "plots")} <= set(modules)
    assert {"im2im_uq_tpu_torch.data.grain_pipeline", "im2im_uq_tpu_torch.models.resnet",
            "im2im_uq_tpu_torch.utils.profiling"} <= set(modules)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK, *modules], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"ok {len(modules)}"


def test_port_sources_name_no_jax_import():
    for path in Path(im2im_uq_tpu_torch.__file__).parent.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "flax", "grain"), (path, line)


def test_chip_smoke_names_no_module_of_the_jax_package():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    named = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for alias in node.names]
    named += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    assert "im2im_uq_tpu_torch" in {n.split(".")[0] for n in named}
    leaked = [n for n in named if n.split(".")[0] in ("im2im_uq_tpu", "jax", "flax", "grain")]
    assert not leaked, leaked


def _imported_roots(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    named = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for alias in node.names]
    named += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module and not node.level]
    return [n.split(".")[0] for n in named]


def test_port_sources_import_nothing_of_the_jax_package():
    paths = sorted(Path(im2im_uq_tpu_torch.__file__).parent.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(paths) > 30
    for path in paths:
        leaked = [n for n in _imported_roots(path)
                  if n in ("im2im_uq_tpu", "jax", "flax", "grain")]
        assert not leaked, (path, leaked)
