"""Vision training on a mesh on the CPU, held against the JAX package:
gloo gangs of ``runtime.worker_main`` run ``tests/dist_support.py``'s
``vision_suite`` on ``tiny-vit`` and ``tiny-clip`` in fp32 over
``VISION_CASES``: ``{model: 2}``, ``{seq: 2}`` (17 image tokens split 9
and 8) in a 2-rank gang; ``{model: 4}`` (tiny-vit's 10 classes whole on
every rank), ``{data: 2, model: 2}``, ``{fsdp: 2, seq: 2}``,
``{model: 2, seq: 2}``, ``{pipeline: 2, model: 2}`` and ``{expert: 2,
seq: 2}`` (axes no vision leaf names) in a 4-rank gang; JAX's own test
mesh ``{data: 2, fsdp: 2, model: 2}`` as one 8-rank gang:

- the loss and metrics, and every gradient leaf (the ranks' synced blocks,
  assembled), against JAX's ``vit_loss(mesh=)`` / ``clip_loss(mesh=)`` on
  the same mesh of virtual devices from the same init and global batch:
  1e-5 of the reference's magnitude;
- the params after two steps of the task against JAX's
  ``setup_vit_train`` / ``setup_clip_train`` step on that mesh (SGD, as
  tests/test_torch_vision.py's one-step check): within 1e-5;
- every leaf's spec JAX's ``shard_params`` on the same mesh.

JAX's references run in helper processes beside the gangs.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from dist_support import (  # noqa: E402
    VISION_BATCH, VISION_CASES, VISION_OPT, VISION_STEPS, finish, spawn_gang,
    vision_cfg, whole_tree,
)
from kubeflow_tpu.models import vision as jvis  # noqa: E402
from kubeflow_tpu.parallel import sharding as jsharding  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from kubeflow_tpu.train import optim as joptim  # noqa: E402
from kubeflow_tpu.train import vision_task as jtask  # noqa: E402
from kubeflow_tpu_torch.models import vision as tvis  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

TOL = 1e-5
CASES = [(w, n) for w, cases in VISION_CASES.items() for n in cases]
IDS = [n for _, n in CASES]


def _jax_cfg(family: str):
    import dataclasses

    if family == "vit":
        return jvis.vit_preset("tiny-vit", dtype="float32")
    base = jvis.clip_preset("tiny-clip")
    return dataclasses.replace(base, image=dataclasses.replace(
        base.image, dtype="float32"), dtype="float32")


def _init(family: str) -> dict:
    """The port's init of the family (seed 0, what every rank draws)."""
    cfg = vision_cfg(family)
    fn = tvis.init_vit_params if family == "vit" else tvis.init_clip_params
    return T.map_tree(lambda t: t.numpy(), fn(torch.Generator().manual_seed(
        0), cfg))


def _jax_case(world: int, name: str, init: dict) -> dict:
    """JAX's loss, metrics and gradients on the case's mesh of virtual
    devices, its specs, and the params after ``VISION_STEPS`` steps of its
    task, all from ``init``."""
    axes, family = VISION_CASES[world][name]
    mesh = jax_mesh(axes, jax.devices()[:world])
    cfg = _jax_cfg(family)
    specs = (jvis.vit_param_specs(cfg) if family == "vit"
             else jvis.clip_param_specs(cfg))
    loss_fn = jvis.vit_loss if family == "vit" else jvis.clip_loss
    batch_fn = jtask.vit_batch if family == "vit" else jtask.clip_batch
    setup = (jtask.setup_vit_train if family == "vit"
             else jtask.setup_clip_train)
    params = jax.tree.map(jnp.asarray, init)
    shardings = jsharding.shard_params(params, specs, mesh)
    task = setup(cfg, joptim.OptimizerConfig(**VISION_OPT), mesh)
    batch = jax.device_put(batch_fn(cfg, VISION_BATCH, 0),
                           task.batch_shardings)
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg, mesh=mesh), has_aux=True))(
        jax.device_put(params, shardings), batch)
    opt = joptim.make_optimizer(joptim.OptimizerConfig(**VISION_OPT))
    state = jax.device_put({"params": params, "opt_state": opt.init(params),
                            "step": jnp.int32(0)}, task.state_shardings)
    for step in range(VISION_STEPS):
        state, _ = task.step_fn(state, jax.device_put(
            batch_fn(cfg, VISION_BATCH, step), task.batch_shardings))
    flat_sh = T.flatten(jax.tree.map(
        lambda s: tuple(s.spec), shardings,
        is_leaf=lambda x: isinstance(x, NamedSharding)))
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": T.flatten(jax.tree.map(np.asarray, grads)),
            "params": T.flatten(jax.tree.map(np.asarray, state["params"])),
            "specs": flat_sh}


#: The helper processes JAX's references are split over, each on two
#: cores: with the gangs beside them (one at a time), this file keeps at
#: most 8 ranks and 4 cores of helpers busy, whatever else runs on the
#: machine.
HELPERS = 2
#: The helpers' XLA compiles its CPU code without LLVM's optimizations:
#: half the compile work of the references' 30 programs, the same
#: functions (their sums in another order: within 1.3e-06 of the default
#: build's, a tenth of the tolerance).
HELPER_ENV = dict(os.environ, XLA_FLAGS=" ".join(
    [os.environ.get("XLA_FLAGS", ""), "--xla_backend_optimization_level=0",
     "--xla_llvm_disable_expensive_passes=true"]).strip())


def jax_refs(out_path: str, part: int) -> None:
    """``_jax_case`` of every ``HELPERS``-th case from ``part``, pickled to
    ``out_path``: what one of the fixture's helper processes computes
    while the gangs run."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[(2 * part + i) % len(cores)]
                             for i in range(2)})
    inits = {f: _init(f) for f in ("vit", "clip")}
    with open(out_path, "wb") as f:
        pickle.dump({(w, n): _jax_case(w, n, inits[VISION_CASES[w][n][1]])
                     for w, n in CASES[part::HELPERS]}, f)


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The 2-, 4- and 8-rank gangs one after another, and JAX's references
    in ``HELPERS`` processes beside them (a rank waits up to 180 s for the
    others to join: eight ranks start beside the helpers' compiles)."""
    base = tmp_path_factory.mktemp("vision_mesh")
    here = Path(__file__).resolve().parent
    helpers = []
    for part in range(HELPERS):
        out = base / f"jax_refs{part}.pkl"
        code = (f"import sys; sys.path[:0] = [{str(here)!r}, "
                f"{str(here.parent)!r}]; import {Path(__file__).stem} as m; "
                f"m.jax_refs({str(out)!r}, {part})")
        log = open(base / f"jax_refs{part}.log", "w+")
        helpers.append((subprocess.Popen(
            [sys.executable, "-c", code], stdout=log,
            stderr=subprocess.STDOUT, cwd=here.parent, env=HELPER_ENV),
            log, out))
    runs, res, rcs = {}, {}, []
    try:
        for world in VISION_CASES:
            d = base / f"world{world}"
            runs[world] = (d, spawn_gang(
                "dist_support:vision_suite", {"out": str(d)}, world,
                [d / f"w{r}" for r in range(world)], timeout_s=180.0))
            res[world] = finish(runs[world][1], timeout=400)
        rcs = [proc.wait(timeout=600) for proc, _, _ in helpers]
    finally:
        for world, (d, procs) in runs.items():
            if world not in res:
                res[world] = finish(procs, timeout=30)
        logs = []
        for proc, log, _ in helpers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.seek(0)
            logs.append(log.read())
            log.close()
    for rc, text in zip(rcs, logs):
        assert rc == 0, f"JAX references exit {rc}:\n{text[-4000:]}"
    ranks = {}
    for world, (d, _) in runs.items():
        for r, (rc, _, err) in enumerate(res[world]):
            assert rc == 0, f"world {world} rank {r} exit {rc}:\n" \
                f"{err[-4000:]}"
        recs = [torch.load(d / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
        for name in VISION_CASES[world]:
            ranks[world, name] = [rec[name] for rec in recs]
    refs = {}
    for _, _, out in helpers:
        with open(out, "rb") as f:
            refs.update(pickle.load(f))
    return {"refs": refs, "ranks": ranks}


def _close_leaves(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want), what
    for p, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[p], np.float64) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (what, p, err)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_loss_metrics_and_every_gradient_match_jax(gangs, world, name):
    ref = gangs["refs"][world, name]
    recs = gangs["ranks"][world, name]
    for rec in recs:
        m = rec["metrics"]
        assert set(m) == set(ref["metrics"])
        assert abs(m["loss"] - ref["loss"]) <= TOL * max(1.0, ref["loss"])
        for k, v in ref["metrics"].items():
            assert abs(m[k] - v) <= TOL * max(1.0, abs(v)), k
    got = whole_tree(recs, lambda r: r["grads"])
    _close_leaves({p: t.numpy() for p, t in got.items()}, ref["grads"], TOL,
                  "grads")


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_two_steps_match_the_jax_task(gangs, world, name):
    ref = gangs["refs"][world, name]
    recs = gangs["ranks"][world, name]
    got = whole_tree(recs, lambda r: r["params"])
    for p, w in ref["params"].items():
        err = float(np.abs(got[p].numpy().astype(np.float64)
                           - np.asarray(w, np.float64)).max())
        assert err <= TOL, (p, err)
    for rec in recs:
        assert len(rec["steps"]) == VISION_STEPS
        assert all(np.isfinite(v) for s in rec["steps"] for v in s.values())


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_specs_are_jaxs(gangs, world, name):
    """Each leaf's spec is JAX's ``shard_params`` on the same mesh (a dim
    that does not divide is replicated: tiny-vit's head on ``{model:
    4}``)."""
    ref = gangs["refs"][world, name]["specs"]
    spec = gangs["ranks"][world, name][0]["specs"]

    def norm(s):
        s = tuple(s)
        while s and s[-1] is None:
            s = s[:-1]
        return s

    assert {p: norm(s) for p, s in spec.items()} == \
        {p: norm(s) for p, s in ref.items()}
    if name == "model4-vit":
        assert "model" not in norm(spec["head"])
