"""The port stands alone: ``kubeflow_tpu_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor anything of the JAX package ``kubeflow_tpu`` —
not even its jax-free modules — and import ``triton`` only inside the
function that launches a Triton kernel. The optional gRPC front end's
``grpc`` and ``google.protobuf`` appear only in ``serve/grpc_server.py``
and ``serve/protos/``.

Three checks: every module of the package imports in a fresh interpreter
with ``jax`` and ``kubeflow_tpu`` blocked in ``sys.modules`` (this test
process has jax loaded already, hence the subprocess); every module but
the gRPC ones imports with ``grpc`` and ``google.protobuf`` blocked too;
and a static scan of every import statement in the package's source."""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from port_threads import torch_on_one_thread  # noqa: F401

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
    # the predictor-replica slice
    "runtime.bootstrap", "runtime.entrypoints", "runtime.worker_main",
    "serve.storage", "serve.explain", "serve.model_server",
    "loadgen.scenario", "loadgen.runner", "loadgen.report", "loadgen.gate",
    # the engine-roles and host-tier slice: copies of jax-free JAX modules
    "serve.handoff", "serve.retry",
    # the fleet's failure path: the remote KV tier's store, the router,
    # the chaos harness and the span export (copies of jax-free modules)
    "pipelines.artifacts", "serve.router", "serve.faults", "obs.fleet",
    # many models and many adapters on one card: multi-tenant LoRA, the
    # model repository, and the gRPC front end with its messages
    "serve.lora", "serve.repository", "serve.grpc_server",
    "serve.protos.oip_pb2",
    # MoE training and the training entry points: the vision models and
    # task, and the copy of the jax-free torch_train adapter
    "models.vision", "train.vision_task", "train.entrypoints",
    "train.adapters",
)
#: The optional gRPC dependency, and the only modules that may import it.
GRPC_ROOTS = ("grpc", "google")
GRPC_MODULES = ("serve.grpc_server", "serve.protos")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
blocked, skip = %r, %r
for name in blocked:
    sys.modules[name] = None
import kubeflow_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(kubeflow_tpu_torch.__path__,
                                                "kubeflow_tpu_torch.")]
mods = [m for m in mods if not m.startswith(skip)]
for m in mods:
    importlib.import_module(m)
leaked = sorted(k for k in sys.modules if sys.modules[k] is not None
                and any(k == b or k.startswith(b + ".")
                        for b in blocked + ("triton",)))
assert not leaked, leaked
print(json.dumps(mods))
"""


def _import_all(blocked: tuple, skip: tuple = ()) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL % (blocked, skip)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout))


def _grpc_modules() -> tuple:
    return tuple(f"kubeflow_tpu_torch.{m}" for m in GRPC_MODULES)


def test_package_imports_with_jax_and_the_jax_package_blocked():
    # The gRPC modules need grpcio; where it is absent they are left to the
    # next test's check that nothing else needs it.
    has_grpc = importlib.util.find_spec("grpc") is not None
    skip = () if has_grpc else _grpc_modules()
    mods = _import_all(FORBIDDEN, skip)
    assert len(mods) >= 20
    missing = [m for m in SLICE_MODULES
               if f"kubeflow_tpu_torch.{m}" not in mods
               and not (skip and f"kubeflow_tpu_torch.{m}".startswith(skip))]
    assert not missing, missing


def test_package_imports_without_grpc_and_protobuf():
    """A machine without grpcio still imports every other module (the
    server imports the gRPC front end only when given a ``grpc_port``)."""
    skip = _grpc_modules()
    mods = _import_all(FORBIDDEN + ("grpc", "google.protobuf"), skip)
    assert len(mods) >= 20
    missing = [m for m in SLICE_MODULES
               if f"kubeflow_tpu_torch.{m}" not in mods
               and not f"kubeflow_tpu_torch.{m}".startswith(skip)]
    assert not missing, missing
    assert "kubeflow_tpu_torch.serve.server" in mods


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
            if root in GRPC_ROOTS:
                assert path.is_relative_to(PKG), f"{path}: imports {name}"
                rel = path.relative_to(PKG).with_suffix("")
                assert str(rel).replace("/", ".").startswith(
                    GRPC_MODULES), f"{path}: imports {name}"
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


_RELOAD = """
import importlib, torch
from kubeflow_tpu_torch.ops import flash_attention as F
op = torch.ops.kftpu_torch.flash_fwd.default
F = importlib.reload(F)                 # a second import of the module
assert F.flash_fwd_op is op is torch.ops.kftpu_torch.flash_fwd.default
calls = []
real = F._flash_fwd_impl
F._flash_fwd_impl = lambda *a: calls.append(1) or real(*a)
q = torch.randn(1, 8, 4, 64, requires_grad=True)
k, v = torch.randn(1, 8, 2, 64), torch.randn(1, 8, 2, 64)
o, lse = F.flash_attention(q, k, v)
o.sum().backward()
assert calls == [1] and q.grad is not None
print("ok")
"""


def test_the_flash_op_registers_once_across_reimports():
    """``ops/flash_attention.py`` registers ``kftpu_torch::flash_fwd`` and
    ``::flash_bwd`` with the dispatcher on import; a reload finds them and
    registers nothing, and the op then runs the reloaded module's code."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _RELOAD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
