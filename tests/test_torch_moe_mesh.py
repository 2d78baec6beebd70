"""MoE training on a mesh on the CPU, held against the JAX package: a
4-rank gloo gang of ``runtime.worker_main`` runs ``tests/dist_support.py``'s
``moe_suite`` on ``tiny-moe`` in fp32 over six meshes: ``{expert: 4}`` (one
expert a rank), ``{data: 2, expert: 2}`` with binding capacity,
``{fsdp: 2, expert: 2}`` (expert leaves split on two dims),
``{seq: 2, expert: 2}`` with ``ring_flash``, ``{expert: 2, model: 2}``
and ``{data: 2, seq: 2}`` with binding capacity and no expert axis:

- ``decoder_loss``, ``aux_loss`` and every gradient, the router's
  included (the ranks' synced blocks, assembled), against JAX's
  ``decoder_loss(mesh=...)`` on the same mesh of virtual devices: 1e-5 of
  the reference's magnitude; ``{expert: 4}`` also on the dense path;
- 5 ``Trainer`` steps against JAX's ``Trainer`` on the same mesh, init and
  global batches: the step-1 grad norm within 1e-4 (relative), every
  parameter after step 1 within 1e-5 of its leaf's largest magnitude, the
  5-step curve within 1e-3;
- the sharded init bit for bit the one-process draw, and every leaf's
  spec JAX's ``shard_params`` on the same mesh;
- where capacity binds, JAX's plan over the global batch drops pairs that
  a plan of each rank's tokens alone would keep, and the port drops as
  many pairs in every layer as JAX's;
- the ``{fsdp: 2, expert: 2}`` checkpoint restored at world 1 and on
  ``{expert: 4}``, bit for bit;
- ``llm_pretrain`` (``tiny-moe``) and ``torch_train`` on ``{expert: 2}``
  through two ``worker_main`` processes.
"""

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
    ENTRY_CONFIGS, MOE_CASES, MOE_CKPT_CASE, MOE_DENSE_CASE, STEPS,
    check_gang, entry_dirs, finish, spawn_gang, tp_tokens,
    train_config, whole_tree,
)
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
from kubeflow_tpu.models import layers as jlayers  # noqa: E402
from kubeflow_tpu.parallel import sharding as jsharding  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from kubeflow_tpu.train import data as jdata  # noqa: E402
from kubeflow_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu.train.trainer import (  # noqa: E402
    TrainerConfig as JTrainerConfig,
)
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.decoder import (  # noqa: E402
    decoder_param_specs,
)
from kubeflow_tpu_torch.parallel.sharding import (  # noqa: E402
    all_coords, cut_local, shard_params,
)
from kubeflow_tpu_torch.runtime.mesh import MESH_AXES  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from kubeflow_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager, ShardLayout,
)
from kubeflow_tpu_torch.train.optim import OptimizerConfig  # noqa: E402
from kubeflow_tpu_torch.train.step import setup_train  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

WORLD = 4
CASES = list(MOE_CASES)
LOSS_CASES = [(n, "dispatch") for n in CASES] + [(MOE_DENSE_CASE, "dense")]
#: The cases whose capacity binds.
BINDING = [n for n, c in MOE_CASES.items()
           if c[4].get("capacity_factor", 1.25) < 1.0]


def _dp(axes: dict) -> int:
    return axes.get("dcn", 1) * axes.get("data", 1) * axes.get("fsdp", 1)


class _Global:
    """The global batch of a step: the batch shards ``0..dp-1`` of the
    JAX package's data module, concatenated."""

    def __init__(self, cfg, dp: int):
        self.srcs = [jdata.make_data_source(cfg, shard=i, num_shards=dp)
                     for i in range(dp)]

    def batch_at(self, step: int) -> np.ndarray:
        return np.concatenate([s.batch_at(step) for s in self.srcs])


def _jax_cfg(name: str, impl: str = "dispatch"):
    _, _, _, chunk, over = MOE_CASES[name]
    return jconfig.preset("tiny-moe", dtype="float32", loss_chunk_size=chunk,
                          moe_impl=impl, **over)


def _jax_attn(name: str) -> str:
    return "ring" if MOE_CASES[name][1].startswith("ring") else "xla"


def _jax_loss_grads(name: str, impl: str, init: dict):
    """JAX's ``decoder_loss(mesh=...)`` and its gradients on the case's
    mesh over virtual devices, sharded params and batch."""
    axes = MOE_CASES[name][0]
    mesh = jax_mesh(axes, jax.devices()[:WORLD])
    cfg = _jax_cfg(name, impl)
    params = jax.tree.map(jnp.asarray, init)
    shardings = jsharding.shard_params(params, jdecoder.decoder_param_specs(
        cfg), mesh)
    params = jax.tree.map(jax.device_put, params, shardings)
    toks = jax.device_put(jnp.asarray(tp_tokens()), NamedSharding(
        mesh, jsharding.logical_to_mesh_axes(("batch", None))))

    def loss_fn(p, t):
        return jdecoder.decoder_loss(p, t, cfg, attn_impl=_jax_attn(name),
                                     mesh=mesh)

    (_, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, toks)
    return ({k: float(m[k]) for k in ("ce_loss", "aux_loss", "accuracy")},
            jax.tree.map(np.asarray, grads))


def _jax_run(name: str, init: dict) -> dict:
    """JAX's Trainer on the case's mesh from the port's init, on the
    global batches of the port's data shards."""
    axes, _, _, chunk, over = MOE_CASES[name]
    conf = train_config(_jax_attn(name), chunk=chunk, model="tiny-moe",
                        **over)
    jt = JTrainer(JTrainerConfig.from_dict(conf),
                  jax_mesh(axes, jax.devices()[:WORLD]))
    jt.data = _Global(jt.data_cfg, _dp(axes))
    params = jax.tree.map(jnp.asarray, init)
    jt.task.state = jax.device_put(
        {"params": params, "opt_state": jt.task.optimizer.init(params),
         "step": jnp.int32(0)}, jt.task.state_shardings)
    rec = {"losses": [], "aux": [], "grad_norms": []}

    def on_step(step, m):
        rec["losses"].append(m["loss"])
        rec["aux"].append(m["aux_loss"])
        rec["grad_norms"].append(m["grad_norm"])
        if step == 1:
            rec["params1"] = jax.tree.map(np.asarray,
                                          jt.task.state["params"])

    jt.run(on_step=on_step)
    return rec


#: The cases whose JAX ``Trainer`` runs in the fixture's helper process
#: (the rest run in the test process after its loss references).
HELPER_RUNS = CASES[:4]


def jax_runs(init_path: str, out_path: str) -> None:
    """``_jax_run`` of each ``HELPER_RUNS`` case from the flattened init
    in ``init_path`` (an .npz), pickled to ``out_path``: what the
    fixture's helper process computes while the gangs and the loss
    references run in the test process."""
    init = T.unflatten(dict(np.load(init_path)))
    with open(out_path, "wb") as f:
        pickle.dump({name: _jax_run(name, init) for name in HELPER_RUNS},
                    f)


def _start_jax_runs(init_np: dict, base) -> tuple:
    """A Python process running ``jax_runs`` (JAX on the same virtual
    devices: the environment carries the XLA flags), its log and its
    output path."""
    init_path, out = base / "jax_init.npz", base / "jax_runs.pkl"
    np.savez(init_path, **T.flatten(init_np))
    here = Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(here)!r}, "
            f"{str(here.parent)!r}]; import {Path(__file__).stem} as m; "
            f"m.jax_runs({str(init_path)!r}, {str(out)!r})")
    log = open(base / "jax_runs.log", "w+")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=log,
                            stderr=subprocess.STDOUT, cwd=here.parent)
    return proc, log, out


def _kept(ids: np.ndarray, c: int, e: int) -> np.ndarray:
    """The choice-major capacity plan of ``ids`` [T, k]: kept [k, T]."""
    t, k = ids.shape
    flat = ids.T.reshape(-1)
    pos = np.cumsum(np.eye(e, dtype=np.int64)[flat], axis=0) - 1
    return (pos[np.arange(k * t), flat] < c).reshape(k, t)


def _jax_plans(name: str, init: dict) -> dict:
    """Each layer's router choices in JAX's forward of the global batch
    (the MoE blocks' inputs, recorded by a callback as the layers run), and the
    pairs kept by the plan over the global batch (JAX's: GSPMD sees that
    batch whole) and by a plan of each rank's tokens alone: layer →
    (global kept [B, S, k], per-rank kept [B, S, k])."""
    axes = MOE_CASES[name][0]
    cfg = _jax_cfg(name)
    dp, n = _dp(axes), axes.get("seq", 1)
    e, k = cfg.num_experts, cfg.experts_per_token
    inputs = jnp.asarray(tp_tokens())[:, :-1]
    seen = []
    block = jlayers.moe_block

    def recorded(p, x, c, **kw):
        logits = jnp.einsum("bsd,de->bse", x, p["router"].astype(
            c.activation_dtype)).astype(jnp.float32)
        jax.debug.callback(lambda ids: seen.append(np.asarray(ids)),
                           jax.lax.top_k(logits, k)[1], ordered=True)
        return block(p, x, c, **kw)

    jlayers.moe_block = recorded
    try:
        jax.jit(lambda p, t: jdecoder.decoder_forward(p, t, cfg))(
            jax.tree.map(jnp.asarray, init), inputs)
        jax.effects_barrier()
    finally:
        jlayers.moe_block = block
    out = []
    for ids in seen[:cfg.n_layers]:
        b, s, _ = ids.shape
        whole = _kept(ids.reshape(b * s, k), jlayers.moe_capacity(
            cfg, b * s), e).T.reshape(b, s, k)
        ranks = np.zeros_like(whole)
        rb, rs = b // dp, s // n
        c_rank = jlayers.moe_capacity(cfg, rb * rs)
        for bi in range(dp):
            for si in range(n):
                blk = (slice(bi * rb, (bi + 1) * rb),
                       slice(si * rs, (si + 1) * rs))
                ranks[blk] = _kept(ids[blk].reshape(rb * rs, k), c_rank,
                                   e).T.reshape(rb, rs, k)
        out.append((whole, ranks))
    return out


#: ``llm_pretrain`` on tiny-moe; ``torch_train`` as the TP file runs it.
MOE_ENTRY = {
    "llm_pretrain": dict(ENTRY_CONFIGS["llm_pretrain"], model="tiny-moe"),
    "torch_train": ENTRY_CONFIGS["torch_train"],
}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang and, beside it, JAX's ``Trainer`` references of
    ``HELPER_RUNS`` in a helper process (``jax_runs``); in the test
    process the one-process init, JAX's loss and plan references and the
    other ``Trainer`` references, then the entry points' two-rank gangs
    on ``{expert: 2}`` (``MOE_ENTRY``)."""
    base = tmp_path_factory.mktemp("moe_mesh")
    init = T.map_tree(lambda t: t.detach().clone(), setup_train(
        preset("tiny-moe", dtype="float32"), OptimizerConfig(),
        device="cpu").params)
    init_np = T.map_tree(lambda t: t.numpy(), init)
    runs, log, runs_out = _start_jax_runs(init_np, base)
    procs = spawn_gang("dist_support:moe_suite", {"out": str(base)}, WORLD,
                       [base / f"w{r}" for r in range(WORLD)],
                       parallelism={"fsdp": WORLD})
    refs, entry, res = {}, {}, None
    try:
        for name, impl in LOSS_CASES:
            refs[name, impl] = _jax_loss_grads(name, impl, init_np)
        for name in BINDING:
            refs[name, "plans"] = _jax_plans(name, init_np)
        for name in CASES[len(HELPER_RUNS):]:
            refs[name, "run"] = _jax_run(name, init_np)
        res = finish(procs)
        for name, conf in MOE_ENTRY.items():
            dirs = entry_dirs(base, name, 2)
            entry[name] = (dirs, spawn_gang(name, conf, 2, dirs,
                                            parallelism={"expert": 2}))
        runs_rc = runs.wait(timeout=600)
    finally:
        if res is None:
            res = finish(procs)
        entry = {n: (d, finish(p, timeout=180)) for n, (d, p) in
                 entry.items()}
        if runs.poll() is None:
            runs.kill()
            runs.wait()
        log.seek(0)
        runs_log = log.read()
        log.close()
    assert runs_rc == 0, (f"JAX Trainer references exit {runs_rc}:\n"
                          f"{runs_log[-4000:]}")
    with open(runs_out, "rb") as f:
        refs.update({(n, "run"): r for n, r in pickle.load(f).items()})
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} exit {rc}:\n{err[-4000:]}"
    recs = [torch.load(base / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return {"base": base, "refs": refs, "init": init, "entry": entry,
            "ranks": {n: [rec[n] for rec in recs] for n in CASES}}


def _close_leaves(got: dict, want: dict, tol: float) -> None:
    for p, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[p], np.float64) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (p, err)


@pytest.mark.parametrize("name,impl", LOSS_CASES,
                         ids=[f"{n}-{i}" for n, i in LOSS_CASES])
def test_loss_aux_and_every_gradient_match_jax_on_the_mesh(gang, name,
                                                           impl):
    want, grads = gang["refs"][name, impl]
    recs = [r[impl] for r in gang["ranks"][name]]
    for rec in recs:
        for key in ("ce_loss", "aux_loss"):
            assert abs(rec[key] - want[key]) <= 1e-5 * abs(want[key]), key
        assert rec["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
    got = whole_tree(gang["ranks"][name], lambda r: r[impl]["grads"])
    want_g = T.flatten(grads)
    assert set(got) == set(want_g)
    assert np.abs(want_g["layers/mlp/router"]).max() > 0
    _close_leaves(got, want_g, 1e-5)


@pytest.mark.parametrize("name", CASES)
def test_trainer_tracks_jaxs_trainer_on_the_mesh(gang, name):
    j = gang["refs"][name, "run"]
    recs = gang["ranks"][name]
    for rec in recs:
        assert abs(rec["grad_norms"][0] - j["grad_norms"][0]) \
            <= 1e-4 * j["grad_norms"][0]
        for key in ("losses", "aux"):
            got, want = np.array(rec[key]), np.array(j[key])
            assert len(got) == len(want) == STEPS
            assert np.abs(got - want).max() <= 1e-3, (key, got, want)
    _close_leaves(whole_tree(recs, lambda r: r["params1"]),
                  T.flatten(j["params1"]), 1e-5)


@pytest.mark.parametrize("name", CASES)
def test_sharded_init_is_the_one_process_draw(gang, name):
    got = whole_tree(gang["ranks"][name], lambda r: r["init"])
    for p, w in T.flatten(gang["init"]).items():
        assert torch.equal(got[p], w), p


@pytest.mark.parametrize("name", CASES)
def test_every_leafs_spec_is_jaxs_on_the_mesh(gang, name):
    """The specs the port's ranks laid their state out by
    (``decoder_param_specs`` through ``shard_params``) are JAX's
    ``shard_params`` of its spec tree on the same mesh, leaf by leaf."""
    axes = MOE_CASES[name][0]
    mesh = jax_mesh(axes, jax.devices()[:WORLD])
    cfg = _jax_cfg(name)
    params = jax.eval_shape(lambda: jdecoder.init_decoder_params(
        jax.random.PRNGKey(0), cfg))
    theirs = T.flatten(jsharding.shard_params(
        params, jdecoder.decoder_param_specs(cfg), mesh))
    mine = gang["ranks"][name][0]["specs"]
    assert set(mine) == set(theirs)
    for p, sh in theirs.items():
        want = tuple(sh.spec) + (None,) * (len(mine[p]) - len(sh.spec))
        assert tuple(mine[p]) == want, (p, mine[p], want)


@pytest.mark.parametrize("name", CASES)
def test_expert_ranks_hold_their_experts_and_columns(gang, name):
    """``gate [L, E, D, M]`` keeps E / expert experts and M / model
    columns on a rank, D gathered over fsdp; the router is whole over
    expert and model."""
    axes = MOE_CASES[name][0]
    ep, tp, fsdp = (axes.get(a, 1) for a in ("expert", "model", "fsdp"))
    for rec in gang["ranks"][name]:
        mlp = rec["init"]["layers"]["mlp"]
        assert mlp["gate"].shape == (2, 4 // ep, 64 // fsdp, 128 // tp)
        assert mlp["down"].shape == (2, 4 // ep, 128 // tp, 64 // fsdp)
        assert mlp["router"].shape == (2, 64 // fsdp, 4)
        assert rec["specs"]["layers/mlp/gate"][1] == "expert"


def _port_kept(recs: list, layer: int, axes: dict) -> np.ndarray:
    """The pairs the port's ranks kept in ``layer``, put together over
    the token ranks in the global (b, s) order: [B, S, k]."""
    dp, n = _dp(axes), axes.get("seq", 1)
    b, s = tp_tokens().shape[0], tp_tokens().shape[1] - 1
    rb, rs = b // dp, s // n
    out = np.zeros((b, s, 2), bool)
    for r in recs:
        c = r["coords"]
        if c["expert"] or c["model"]:
            continue
        bi = (c["dcn"] * axes.get("data", 1) + c["data"]) \
            * axes.get("fsdp", 1) + c["fsdp"]
        keep = r["dispatch"]["keeps"][layer].numpy().reshape(2, rb, rs)
        out[bi * rb:(bi + 1) * rb, c["seq"] * rs:(c["seq"] + 1) * rs] = \
            keep.transpose(1, 2, 0)
    return out


@pytest.mark.parametrize("name", BINDING)
def test_binding_capacity_plans_over_the_global_batch(gang, name):
    """JAX's plan over the global batch drops pairs that a plan of each
    rank's tokens alone would keep (so the two plans differ), and the
    port's ranks keep exactly JAX's pairs in every layer, so they drop as
    many."""
    axes = MOE_CASES[name][0]
    recs = gang["ranks"][name]
    for layer, (whole, ranks) in enumerate(gang["refs"][name, "plans"]):
        assert (~whole & ranks).sum() > 0, layer
        port = _port_kept(recs, layer, axes)
        assert int((~port).sum()) == int((~whole).sum()), layer
        assert np.array_equal(port, whole), layer


@pytest.mark.parametrize("mesh", [None, {"expert": 4}],
                         ids=["world1", "expert4"])
def test_checkpoint_split_over_expert_and_fsdp_restores_bit_for_bit(
        gang, mesh):
    """The ``{fsdp: 2, expert: 2}`` run's step-2 checkpoint (expert
    leaves' blocks split on E over expert and on D over fsdp) read whole
    at world 1, and on every rank of ``{expert: 4}`` as that rank's
    blocks: the ranks' step-2 state assembled, bit for bit."""
    recs = gang["ranks"][MOE_CKPT_CASE]
    mgr = CheckpointManager(str(gang["base"] / "ckpt"))
    assert mgr.steps_on_disk() == [2, 4, 5]
    whole = {}
    for sub in ("params", "opt_state/mu", "opt_state/nu"):
        def get(r, sub=sub):
            node = r["state2"]
            for k in sub.split("/"):
                node = node[k]
            return node
        whole.update({f"{sub}/{p}": t
                      for p, t in whole_tree(recs, get).items()})
    layouts = [None]
    if mesh is not None:
        sizes = {a: 1 for a in MESH_AXES}
        sizes.update(mesh)
        params = T.unflatten({p[len("params/"):]: t for p, t in whole.items()
                              if p.startswith("params/")})
        specs = {}
        for p, s in T.flatten(shard_params(params, decoder_param_specs(
                preset("tiny-moe")), sizes)).items():
            for pre in ("params/", "opt_state/mu/", "opt_state/nu/"):
                specs[pre + p] = s
        layouts = [ShardLayout(sizes, c, specs, rank=i, world=WORLD)
                   for i, c in enumerate(all_coords(sizes, MESH_AXES))]
    for lay in layouts:
        got = T.flatten(mgr.restore(2, layout=lay))
        assert got["step"] == 2 and got["opt_state/count"] == 2
        for p, w in whole.items():
            want = w if lay is None else cut_local(
                w, lay.specs.get(p, ()), lay.sizes, lay.coords)
            assert torch.equal(got[p], want), (mesh, p)


@pytest.mark.parametrize("name", list(MOE_ENTRY))
def test_entry_points_on_an_expert_axis(gang, name):
    """``llm_pretrain`` trains tiny-moe on ``{expert: 2}`` through two
    ``worker_main`` processes (an expert a rank), and ``torch_train``
    (data-parallel, no mesh) runs beside such a parallelism."""
    dirs, res = gang["entry"][name]
    assert [rc for rc, _, _ in res] == [0, 0], [e[-3000:] for *_, e in res]
    check_gang(name, 2, MOE_ENTRY[name], dirs)
