"""The port stands alone: ``kubeflow_tpu_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor anything of the JAX package ``kubeflow_tpu`` —
not even its jax-free modules — and import ``triton`` only inside the
function that launches a Triton kernel.

Two checks: every module of the package imports in a fresh interpreter with
``jax`` and ``kubeflow_tpu`` blocked in ``sys.modules`` (this test process
has jax loaded already, hence the subprocess), and a static scan of every
import statement in the package's source."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "kubeflow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kubeflow_tpu")
#: Modules each slice added; the walk below must reach every one of them.
SLICE_MODULES = (
    "serve.engine", "serve.server", "serve.device_state", "ops.fused_norm",
    "ops.flash_attention", "models.decoder",
    # the paged-KV slice
    "serve.paged", "serve.kvtier", "ops.paged_attention",
    "ops.quantization", "runtime.sanitize",
    # the training slice
    "train.tree", "train.optim", "train.data", "train.step", "train.metrics",
    "train.staging", "train.checkpoint", "train.survival", "train.trainer",
    "models.convert",
)

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
for name in %r:
    sys.modules[name] = None
import kubeflow_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(kubeflow_tpu_torch.__path__,
                                                "kubeflow_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in %r and sys.modules[k] is not None)
assert not leaked, leaked
print(json.dumps(mods))
""" % (FORBIDDEN, FORBIDDEN + ("triton",))


def test_package_imports_with_jax_and_the_jax_package_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(json.loads(out.stdout))
    assert len(mods) >= 20
    missing = [m for m in SLICE_MODULES
               if f"kubeflow_tpu_torch.{m}" not in mods]
    assert not missing, missing


def _imports(tree):
    """(module name, is module-level) for every import statement."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 20
    for m in SLICE_MODULES:
        assert PKG.joinpath(*m.split(".")).with_suffix(".py") in files, m
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for name, module_level in _imports(tree):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path}: imports {name}"
            if root == "triton":
                assert not module_level, \
                    f"{path}: triton imported at module level"


def _run_smoke(script: Path, cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card_or_the_package(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line when there is
    no card, or when it stands in a directory without the package."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run")
    out = _run_smoke(REPO / "chip_smoke.py", REPO)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    out = _run_smoke(alone, tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
