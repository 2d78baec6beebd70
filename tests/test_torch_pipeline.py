"""Pipeline parallelism on the CPU (``parallel/pipeline.py`` and the
decoder's staged branch), held against the JAX package:

- the schedules on a toy stage in lockstep (every stage in one process):
  GPipe and 1F1B over 2 and 4 stages, the automatic and explicit
  microbatch counts, outputs and gradients against ``sequential_apply``;
  the microbatch rule and its error JAX's;
- a 4-rank gloo gang of ``runtime.worker_main`` runs ``tests/
  dist_support.py``'s ``pipeline_suite`` over five meshes: ``{pipeline:
  2, data: 2}`` GPipe, ``{pipeline: 4}`` 1F1B, ``{pipeline: 2, model: 2}``
  1F1B, ``{pipeline: 2, expert: 2}`` on tiny-moe with binding capacity,
  ``{pipeline: 2, seq: 2}`` with ``ring_flash`` (and on tiny-moe, GPipe):
  ``decoder_loss``,
  ``aux_loss`` and every gradient (the ranks' synced blocks, assembled)
  against JAX's ``decoder_loss(mesh=...)`` under the rule ``layers →
  pipeline`` on the same mesh of virtual devices, within 1e-5 of the
  reference's magnitude; the MoE case keeps each microbatch's pairs;
  the staged forward's logits the unstaged forward's;
- 5 ``Trainer`` steps on ``{pipeline: 2, data: 2}`` against JAX's (the
  curve within 1e-3), its stage-sharded step-2 checkpoint restored bit
  for bit at world 1 and on ``{pipeline: 4}``;
- the sharded init is the one-process draw, each stage holding its
  layers;
- ``llm_pretrain`` on ``{pipeline: 2}`` through two ``worker_main``
  processes;
- JAX's refusals: custom positions, stages that do not divide the layers,
  a model degree that does not divide the heads.
"""

import dataclasses
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
    ENTRY_CONFIGS, PP_CASES, PP_TRAIN_CASE, STEPS, check_gang, entry_dirs,
    finish, pp_overrides, spawn_gang, tp_tokens, train_config,
    whole_tree,
)
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
from kubeflow_tpu.models import layers as jlayers  # noqa: E402
from kubeflow_tpu.parallel import pipeline as jpipeline  # noqa: E402
from kubeflow_tpu.parallel import sharding as jsharding  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh as jax_mesh  # noqa: E402
from kubeflow_tpu.train import data as jdata  # noqa: E402
from kubeflow_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu.train.trainer import (  # noqa: E402
    TrainerConfig as JTrainerConfig,
)
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.decoder import (  # noqa: E402
    decoder_forward, decoder_param_specs,
)
from kubeflow_tpu_torch.parallel import pipeline as PP  # noqa: E402
from kubeflow_tpu_torch.parallel.sharding import (  # noqa: E402
    DEFAULT_RULES, all_coords, cut_local, shard_params, with_rule,
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
CASES = list(PP_CASES)
PP_RULES = with_rule(DEFAULT_RULES, "layers", "pipeline")


# -- the schedules on a toy stage ----------------------------------------------

def _toy_fn(p, xs):
    return {"h": torch.tanh(xs["h"] @ p["w"] + p["b"]), "g": xs["g"] * p["s"]}


@pytest.mark.parametrize("m", [None, 2, 8])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_schedule_matches_sequential_apply(schedule, n, m):
    """Outputs and every gradient (stage params and streamed inputs) of
    ``pipeline_apply`` in lockstep against the unpipelined stages."""
    gen = torch.Generator().manual_seed(n)
    d, b = 6, 8
    params = PP.stack_stage_params([
        {"w": torch.randn(d, d, generator=gen, dtype=torch.float64),
         "b": torch.randn(d, generator=gen, dtype=torch.float64),
         "s": torch.randn(1, generator=gen, dtype=torch.float64)}
        for _ in range(n)])
    assert params["w"].shape == (n, d, d)
    xs = {"h": torch.randn(b, d, generator=gen, dtype=torch.float64),
          "g": torch.randn(b, 1, generator=gen, dtype=torch.float64)}
    for t in (*params.values(), *xs.values()):
        t.requires_grad_(True)
    got = PP.pipeline_apply(_toy_fn, params, xs, schedule=schedule,
                            num_microbatches=m)
    want = PP.sequential_apply(_toy_fn, params, xs)
    cots = {k: torch.randn(v.shape, generator=gen, dtype=torch.float64)
            for k, v in want.items()}
    ins = [*params.values(), *xs.values()]
    g_got = torch.autograd.grad([got[k] for k in cots], ins,
                                list(cots.values()))
    g_want = torch.autograd.grad([want[k] for k in cots], ins,
                                 list(cots.values()))
    for k in want:
        assert torch.allclose(got[k], want[k], rtol=0, atol=1e-12)
    for a, w in zip(g_got, g_want):
        assert torch.allclose(a, w, rtol=0, atol=1e-12)


def test_microbatch_rule_and_error_are_jaxs():
    """The largest m ≤ 2n (GPipe) or ≤ 4n (1F1B) dividing the local batch,
    and JAX's ``ValueError`` text for a count that does not divide."""
    assert PP.microbatches(8, 1, 2, "gpipe") == 4
    assert PP.microbatches(8, 1, 2, "1f1b") == 8
    assert PP.microbatches(12, 2, 4, "1f1b") == 6
    assert PP.microbatches(6, 1, 4, "gpipe") == 6
    assert PP.microbatches(7, 1, 2, "gpipe") == 1
    mesh = jax_mesh({"pipeline": 2}, jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        jpipeline.pipeline_apply(lambda p, x: x, jnp.zeros((2, 1)),
                                 jnp.zeros((6, 2)), mesh=mesh,
                                 num_microbatches=4)
    with pytest.raises(ValueError) as got:
        PP.microbatches(6, 1, 2, "gpipe", 4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stages,schedule", [(2, "gpipe"), (4, "1f1b")])
def test_staged_loss_and_forward_in_lockstep_are_the_unstaged_ones(
        stages, schedule):
    """Every stage in one process (``staged_loss(stages=)``, the one-card
    chip check's path): the loss and every gradient of 4-layer tiny, and
    the staged forward's logits, against the unstaged ones; both
    schedules give the same gradients."""
    from kubeflow_tpu_torch.models.decoder import (
        decoder_loss, init_decoder_params, staged_forward, staged_loss,
    )

    cfg = preset("tiny", dtype="float32", n_layers=4,
                 pipeline_schedule=schedule)
    params = init_decoder_params(torch.Generator().manual_seed(3), cfg)
    leaves = T.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.from_numpy(tp_tokens())
    want, _ = decoder_loss(params, toks, cfg)
    g_want = torch.autograd.grad(want, leaves)
    got, m = staged_loss(params, toks, cfg, stages=stages)
    g_got = torch.autograd.grad(got, leaves)
    with torch.no_grad():
        logits = staged_forward(params, toks[:, :-1], cfg, stages=stages)
        ref = decoder_forward(params, toks[:, :-1], cfg)[0]
    want = float(want.detach())
    assert float(got.detach()) == pytest.approx(want, rel=1e-6)
    assert float(m["ce_loss"]) == pytest.approx(want, rel=1e-6)
    for a, w in zip(g_got, g_want):
        assert torch.allclose(a, w, rtol=0, atol=1e-5 * float(w.abs().max()))
    assert torch.allclose(logits, ref, rtol=0,
                          atol=1e-5 * float(ref.abs().max()))


def test_a_schedule_whose_stages_all_wait_raises():
    def waits():
        yield PP.Comm(recv="prev")

    with pytest.raises(RuntimeError, match="deadlocked"):
        PP.run_lockstep([waits(), waits()])


# -- the gang against JAX ------------------------------------------------------

class _Global:
    """The global batch of a step: the batch shards ``0..dp-1`` of the JAX
    package's data module, concatenated."""

    def __init__(self, cfg, dp: int):
        self.srcs = [jdata.make_data_source(cfg, shard=i, num_shards=dp)
                     for i in range(dp)]

    def batch_at(self, step: int) -> np.ndarray:
        return np.concatenate([s.batch_at(step) for s in self.srcs])


def _dp(axes: dict) -> int:
    return axes.get("dcn", 1) * axes.get("data", 1) * axes.get("fsdp", 1)


def _jax_cfg(name: str):
    return jconfig.preset(PP_CASES[name][3], **pp_overrides(name))


def _jax_attn(name: str) -> str:
    return "ring" if PP_CASES[name][1].startswith("ring") else "xla"


def _jax_loss_grads(name: str, init: dict):
    """JAX's ``decoder_loss(mesh=...)`` under ``layers → pipeline`` and
    its gradients on the case's mesh of virtual devices."""
    axes = PP_CASES[name][0]
    mesh = jax_mesh(axes, jax.devices()[:WORLD])
    cfg = _jax_cfg(name)
    rules = jsharding.with_rule(jsharding.DEFAULT_RULES, "layers",
                                "pipeline")
    params = jax.tree.map(jnp.asarray, init)
    params = jax.tree.map(jax.device_put, params, jsharding.shard_params(
        params, jdecoder.decoder_param_specs(cfg), mesh, rules))
    toks = jax.device_put(jnp.asarray(tp_tokens()), NamedSharding(
        mesh, jsharding.logical_to_mesh_axes(("batch", None), rules)))

    def loss_fn(p, t):
        return jdecoder.decoder_loss(p, t, cfg, attn_impl=_jax_attn(name),
                                     mesh=mesh, rules=rules)

    (loss, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, toks)
    return ({"loss": float(loss),
             **{k: float(m[k]) for k in ("ce_loss", "aux_loss",
                                         "accuracy")}},
            jax.tree.map(np.asarray, grads))


def _jax_run(name: str, init: dict) -> dict:
    """JAX's Trainer on the case's mesh from the port's init, on the
    global batches of the port's data shards."""
    axes, _, _, model, _ = PP_CASES[name]
    conf = train_config(_jax_attn(name), model=model, **pp_overrides(name))
    jt = JTrainer(JTrainerConfig.from_dict(conf),
                  jax_mesh(axes, jax.devices()[:WORLD]))
    jt.data = _Global(jt.data_cfg, _dp(axes))
    params = jax.tree.map(jnp.asarray, init)
    jt.task.state = jax.device_put(
        {"params": params, "opt_state": jt.task.optimizer.init(params),
         "step": jnp.int32(0)}, jt.task.state_shardings)
    rec = {"losses": [], "grad_norms": []}

    def on_step(step, m):
        rec["losses"].append(m["loss"])
        rec["grad_norms"].append(m["grad_norm"])

    jt.run(on_step=on_step)
    return rec


#: The cases whose JAX loss references run in the fixture's helper
#: process, beside JAX's ``Trainer`` run (the rest run in the test process
#: while the gang does).
HELPER_CASES = CASES[-2:]


def jax_refs(base: str) -> None:
    """The helper process's part of the references: ``_jax_loss_grads`` of
    each ``HELPER_CASES`` case and ``_jax_run`` of ``PP_TRAIN_CASE``, from
    the inits in ``base`` (``init_<case>.npz``), pickled to
    ``base/jax_refs.pkl``."""
    def init(name):
        return T.unflatten(dict(np.load(Path(base, f"init_{name}.npz"))))

    out = {name: _jax_loss_grads(name, init(name))
           for name in HELPER_CASES}
    out["run"] = _jax_run(PP_TRAIN_CASE, init(PP_TRAIN_CASE))
    with open(Path(base, "jax_refs.pkl"), "wb") as f:
        pickle.dump(out, f)


def _start_jax_refs(inits: dict, base: Path):
    """A Python process running ``jax_refs`` (JAX on the same virtual
    devices: the environment carries the XLA flags), and its log."""
    for name in (*HELPER_CASES, PP_TRAIN_CASE):
        np.savez(base / f"init_{name}.npz", **T.flatten(
            T.map_tree(lambda t: t.numpy(), inits[name])))
    here = Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(here)!r}, "
            f"{str(here.parent)!r}]; import {Path(__file__).stem} as m; "
            f"m.jax_refs({str(base)!r})")
    log = open(base / "jax_refs.log", "w+")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=log,
                            stderr=subprocess.STDOUT, cwd=here.parent)
    return proc, log


def _one_process_init(name: str) -> dict:
    axes, _, _, model, _ = PP_CASES[name]
    return T.map_tree(lambda t: t.detach().clone(), setup_train(
        preset(model, **pp_overrides(name)), OptimizerConfig(),
        device="cpu").params)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang's records beside JAX's loss references and Trainer run on
    the one-process inits (part in a helper process, ``jax_refs``), then
    ``llm_pretrain``'s two-rank gang on ``{pipeline: 2}``."""
    base = tmp_path_factory.mktemp("pipeline")
    procs = spawn_gang("dist_support:pipeline_suite", {"out": str(base)},
                       WORLD, [base / f"w{r}" for r in range(WORLD)],
                       parallelism={"fsdp": WORLD})
    refs, res, entry, helper = {}, None, None, None
    conf = dict(ENTRY_CONFIGS["llm_pretrain"],
                model_overrides={"dtype": "float32", "n_layers": 2,
                                 "pipeline_schedule": "1f1b"})
    try:
        inits = {name: _one_process_init(name) for name in CASES}
        helper, log = _start_jax_refs(inits, base)
        for name in CASES:
            if name not in HELPER_CASES:
                refs[name] = _jax_loss_grads(
                    name, T.map_tree(lambda t: t.numpy(), inits[name]))
        res = finish(procs)
        dirs = entry_dirs(base, "llm_pretrain", 2)
        entry = (dirs, finish(spawn_gang("llm_pretrain", conf, 2, dirs,
                                         parallelism={"pipeline": 2}),
                              timeout=180))
        helper_rc = helper.wait(timeout=600)
    finally:
        if res is None:
            res = finish(procs)
        if helper is not None and helper.poll() is None:
            helper.kill()
            helper.wait()
    log.seek(0)
    assert helper_rc == 0, f"JAX references exit {helper_rc}:\n" \
        f"{log.read()[-4000:]}"
    log.close()
    with open(base / "jax_refs.pkl", "rb") as f:
        refs.update(pickle.load(f))
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r} exit {rc}:\n{err[-4000:]}"
    recs = [torch.load(base / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return {"base": base, "refs": refs, "inits": inits, "entry": entry,
            "entry_conf": conf,
            "ranks": {n: [rec[n] for rec in recs] for n in CASES}}


def _close_leaves(got: dict, want: dict, tol: float) -> None:
    for p, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[p], np.float64) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (p, err)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_every_gradient_match_jax_on_the_mesh(gang, name):
    want, grads = gang["refs"][name]
    for rec in gang["ranks"][name]:
        for key in ("loss", "ce_loss", "aux_loss"):
            assert abs(rec[key] - want[key]) <= 1e-5 * abs(want[key]), key
        assert rec["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
    got = whole_tree(gang["ranks"][name], lambda r: r["grads"])
    want_g = T.flatten(grads)
    assert set(got) == set(want_g)
    _close_leaves(got, want_g, 1e-5)
    norm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in want_g.values())))
    for rec in gang["ranks"][name]:
        assert rec["grad_norm"] == pytest.approx(norm, rel=1e-5)


@pytest.mark.parametrize(
    "name", [n for n in CASES if PP_CASES[n][3] == "tiny"])
def test_staged_forward_is_the_unstaged_forward(gang, name):
    """``decoder_forward(mesh=)`` on a pipeline mesh: every rank gets the
    last stage's logits of its rows (and seq part), those of the
    one-process forward of the same init."""
    axes = PP_CASES[name][0]
    cfg = preset("tiny", **pp_overrides(name))
    toks = torch.from_numpy(tp_tokens())[:, :-1]
    with torch.no_grad():
        want = decoder_forward(gang["inits"][name], toks, cfg)[0]
    rows, part = 4 // _dp(axes), toks.shape[1] // axes.get("seq", 1)
    for rec in gang["ranks"][name]:
        c = rec["coords"]
        w = want[c["data"] * rows:(c["data"] + 1) * rows,
                 c["seq"] * part:(c["seq"] + 1) * part]
        assert torch.allclose(rec["logits"], w, rtol=0,
                              atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("name", CASES)
def test_sharded_init_is_the_one_process_draw(gang, name):
    """Each stage holds its block of the stacked layers (the rule
    ``layers → pipeline``), every other leaf whole; together the blocks
    are the one-process draw, bit for bit."""
    axes = PP_CASES[name][0]
    recs = gang["ranks"][name]
    got = whole_tree(recs, lambda r: r["init"])
    for p, w in T.flatten(gang["inits"][name]).items():
        assert torch.equal(got[p], w), p
    n_layers = T.flatten(gang["inits"][name])["layers/ln1"].shape[0]
    for rec in recs:
        assert rec["specs"]["layers/ln1"][0] == "pipeline"
        assert rec["init"]["layers"]["ln1"].shape[0] == \
            n_layers // axes["pipeline"]
        assert rec["specs"]["final_norm"] == (None,)


def _kept(ids: np.ndarray, c: int, e: int) -> np.ndarray:
    """The choice-major capacity plan of ``ids`` [T, k]: kept [k·T]."""
    t, k = ids.shape
    flat = ids.T.reshape(-1)
    pos = np.cumsum(np.eye(e, dtype=np.int64)[flat], axis=0) - 1
    return pos[np.arange(k * t), flat] < c


def test_moe_stage_plans_each_microbatch_alone(gang):
    """Inside a stage each dispatch plans over its microbatch's tokens
    (JAX's stage ``shard_map``): every rank keeps exactly the pairs of a
    plan of those tokens, capacity binds, and a plan over the whole batch
    would keep other pairs."""
    cfg = _jax_cfg("pipe2_expert2")
    e = cfg.num_experts
    differs = 0
    for rec in gang["ranks"]["pipe2_expert2"]:
        assert len(rec["plans"]) == 4      # 1 layer x 4 microbatches
        ids = [p[0].numpy() for p in rec["plans"]]
        for (topk, keep), i in zip(rec["plans"], ids):
            t = i.shape[0] * i.shape[1]
            want = _kept(i.reshape(t, -1), jlayers.moe_capacity(cfg, t), e)
            assert np.array_equal(keep.numpy(), want)
            assert (~want).sum() > 0
        whole = np.concatenate(ids)
        t = whole.shape[0] * whole.shape[1]
        plan = _kept(whole.reshape(t, -1), jlayers.moe_capacity(cfg, t), e)
        per_mb = np.concatenate([k.numpy().reshape(2, -1)
                                 for _, k in rec["plans"]], axis=1)
        differs += not np.array_equal(plan.reshape(2, -1), per_mb)
    assert differs


def test_trainer_tracks_jaxs_trainer_on_the_mesh(gang):
    j = gang["refs"]["run"]
    for rec in gang["ranks"][PP_TRAIN_CASE]:
        assert abs(rec["grad_norms"][0] - j["grad_norms"][0]) \
            <= 1e-4 * j["grad_norms"][0]
        got, want = np.array(rec["losses"]), np.array(j["losses"])
        assert len(got) == len(want) == STEPS
        assert np.abs(got - want).max() <= 1e-3, (got, want)


@pytest.mark.parametrize("mesh", [None, {"pipeline": 4}],
                         ids=["world1", "pipeline4"])
def test_stage_sharded_checkpoint_restores_bit_for_bit(gang, mesh):
    """The ``{pipeline: 2, data: 2}`` run's step-2 checkpoint (each stage
    wrote its layers) read whole at world 1, and on every rank of
    ``{pipeline: 4}`` as that rank's blocks: the ranks' step-2 state
    assembled, bit for bit."""
    recs = gang["ranks"][PP_TRAIN_CASE]
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
                preset("tiny")), sizes, PP_RULES)).items():
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


def test_llm_pretrain_on_a_pipeline_axis(gang):
    """``llm_pretrain`` trains tiny on ``{pipeline: 2}`` (1F1B) through
    two ``worker_main`` processes; only the coordinator logs."""
    dirs, res = gang["entry"]
    assert [rc for rc, _, _ in res] == [0, 0], [e[-3000:] for *_, e in res]
    check_gang("llm_pretrain", 2, gang["entry_conf"], dirs)


# -- JAX's refusals ------------------------------------------------------------

def test_custom_positions_raise_under_pipeline():
    cfg = preset("tiny", dtype="float32")
    toks = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="custom positions"):
        decoder_forward({}, toks, cfg, positions=toks,
                        mesh={"pipeline": 2})


@pytest.mark.parametrize("mesh,over,match", [
    ({"pipeline": 3}, {}, "pipeline=3 must divide n_layers=2"),
    ({"pipeline": 2, "model": 4}, {"n_kv_heads": 2},
     "model=4 must divide"),
    ({"pipeline": 2, "model": 2}, {"mlp_dim": 129}, "must divide"),
], ids=["layers", "kv_heads", "mlp"])
def test_what_does_not_divide_raises_as_in_jax(mesh, over, match):
    cfg = dataclasses.replace(preset("tiny", dtype="float32"), **over)
    with pytest.raises(ValueError, match=match):
        setup_train(cfg, OptimizerConfig(), device="cpu", mesh=mesh)
