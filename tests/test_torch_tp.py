"""Tensor parallelism over the ``model`` axis on the CPU, held against the
JAX package: gloo gangs of ``runtime.worker_main`` (a 2-rank world for
``{model: 2}``, a 4-rank one for ``{model: 4}`` — tiny's 2 kv heads whole
on every rank — ``{fsdp: 2, model: 2}``, ``{data: 2, model: 2}`` and
``{seq: 2, model: 2}`` with ``ring_flash``) run ``tests/dist_support.py``'s
``tp_suite`` on ``tiny`` in fp32, the CE vocab-parallel in each of its
three branches (the fused CE's plain kernels, chunked, dense):

- ``decoder_loss`` and every gradient (the ranks' synced blocks,
  assembled) against JAX's ``decoder_loss(mesh=...)`` on the same mesh of
  virtual devices: 1e-5 of the reference's magnitude;
- 5 ``Trainer`` steps against JAX's ``Trainer`` on the same mesh, init and
  global batches: the step-1 grad norm within 1e-4 (relative), every
  parameter after step 1 within 1e-5 of its leaf's largest magnitude, the
  5-step curve within 1e-3;
- the ``{fsdp: 2, model: 2}`` checkpoint (leaves split on two dims)
  restored at world 1 and on ``{model: 4}``, bit for bit.

Beside them, in one process: the vocab-parallel CE's plain forms against
``reference_cross_entropy`` (nll, lse, accuracy, both gradients) for
vocabularies whose shards are ragged in the kernels' 256-column tiles.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from dist_support import (  # noqa: E402
    ENTRY_CONFIGS, STEPS, TP_CASES, TP_CKPT_CASE, check_gang, entry_dirs,
    finish, spawn_gang, tp_tokens, train_config, whole_tree,
)
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdecoder  # noqa: E402
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
from kubeflow_tpu_torch.ops import fused_xent as fx  # noqa: E402
from kubeflow_tpu_torch.parallel import vocab_parallel as vp  # noqa: E402
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

CASES = [(w, n) for w, cases in TP_CASES.items() for n in cases]


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


def _jax_cfg(chunk: int):
    return jconfig.preset("tiny", dtype="float32", loss_chunk_size=chunk)


def _jax_loss_grads(axes: dict, attn: str, chunk: int, init: dict):
    """JAX's ``decoder_loss(mesh=...)`` and its gradients on the mesh of
    ``axes`` over virtual devices, sharded params and batch."""
    n = int(np.prod(list(axes.values())))
    mesh = jax_mesh(axes, jax.devices()[:n])
    cfg = _jax_cfg(chunk)
    params = jax.tree.map(jnp.asarray, init)
    shardings = jsharding.shard_params(params, jdecoder.decoder_param_specs(
        cfg), mesh)
    params = jax.tree.map(jax.device_put, params, shardings)
    toks = jax.device_put(jnp.asarray(tp_tokens()), NamedSharding(
        mesh, jsharding.logical_to_mesh_axes(("batch", None))))
    impl = "ring" if attn.startswith("ring") else attn

    def loss_fn(p, t):
        return jdecoder.decoder_loss(p, t, cfg, attn_impl=impl, mesh=mesh)

    (loss, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, toks)
    return float(m["ce_loss"]), float(m["accuracy"]), jax.tree.map(
        np.asarray, grads)


def _jax_run(axes: dict, attn: str, chunk: int, init: dict) -> dict:
    """JAX's Trainer on the mesh of ``axes`` from the port's init, on the
    global batches of the port's data shards."""
    n = int(np.prod(list(axes.values())))
    conf = train_config("ring" if attn.startswith("ring") else "xla",
                        chunk=chunk)
    jt = JTrainer(JTrainerConfig.from_dict(conf),
                  jax_mesh(axes, jax.devices()[:n]))
    jt.data = _Global(jt.data_cfg, _dp(axes))
    params = jax.tree.map(jnp.asarray, init)
    jt.task.state = jax.device_put(
        {"params": params, "opt_state": jt.task.optimizer.init(params),
         "step": jnp.int32(0)}, jt.task.state_shardings)
    rec = {"losses": [], "grad_norms": []}

    def on_step(step, m):
        rec["losses"].append(m["loss"])
        rec["grad_norms"].append(m["grad_norm"])
        if step == 1:
            rec["params1"] = jax.tree.map(np.asarray,
                                          jt.task.state["params"])

    jt.run(on_step=on_step)
    return rec


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Both worlds' gangs, started together; the one-process init and
    JAX's references while they run."""
    out, procs = {}, {}
    for world in TP_CASES:
        base = tmp_path_factory.mktemp(f"tp{world}")
        out[world] = base
        procs[world] = spawn_gang(
            "dist_support:tp_suite", {"out": str(base)}, world,
            [base / f"w{r}" for r in range(world)],
            parallelism={"fsdp": world})
    refs = {}
    try:
        init = T.map_tree(lambda t: t.detach().clone(), setup_train(
            preset("tiny", dtype="float32"), OptimizerConfig(),
            device="cpu").params)
        init_np = T.map_tree(lambda t: t.numpy(), init)
        for cases in TP_CASES.values():
            for name, (axes, attn, _, chunk) in cases.items():
                refs[name] = {
                    "loss": _jax_loss_grads(axes, attn, chunk, init_np),
                    "run": _jax_run(axes, attn, chunk, init_np)}
    finally:
        res = {w: finish(p) for w, p in procs.items()}
    for world, rs in res.items():
        for r, (rc, _, err) in enumerate(rs):
            assert rc == 0, f"world {world} rank {r} exit {rc}:\n{err[-4000:]}"
    ranks = {}
    for world, base in out.items():
        recs = [torch.load(base / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
        for name in TP_CASES[world]:
            ranks[name] = [rec[name] for rec in recs]
    return {"out": out, "ranks": ranks, "refs": refs, "init": init}


def _close_leaves(got: dict, want: dict, tol: float) -> None:
    for p, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[p], np.float64) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (p, err)


@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_loss_and_every_gradient_match_jax_on_the_mesh(gangs, world, name):
    loss, acc, grads = gangs["refs"][name]["loss"]
    recs = gangs["ranks"][name]
    for rec in recs:
        assert abs(rec["ce_loss"] - loss) <= 1e-5 * abs(loss)
        assert rec["accuracy"] == pytest.approx(acc, abs=1e-6)
    got = whole_tree(recs, lambda r: r["grads"])
    want = T.flatten(grads)
    assert set(got) == set(want)
    _close_leaves(got, want, 1e-5)


@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_trainer_tracks_jaxs_trainer_on_the_mesh(gangs, world, name):
    j = gangs["refs"][name]["run"]
    recs = gangs["ranks"][name]
    for rec in recs:
        assert abs(rec["grad_norms"][0] - j["grad_norms"][0]) \
            <= 1e-4 * j["grad_norms"][0]
        got = np.array(rec["losses"])
        want = np.array(j["losses"])
        assert len(got) == len(want) == STEPS
        assert np.abs(got - want).max() <= 1e-3, (got, want)
    _close_leaves(whole_tree(recs, lambda r: r["params1"]),
                  T.flatten(j["params1"]), 1e-5)


@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_model_ranks_hold_their_heads_columns_and_vocab(gangs, world, name):
    """wq and lm_head are split over model on their heads and vocab
    columns (and gathered over fsdp on D); wk is split over model unless
    its 2 kv heads do not divide, then whole on every model rank."""
    axes = TP_CASES[world][name][0]
    tp, fsdp = axes.get("model", 1), axes.get("fsdp", 1)
    specs = gangs["ranks"][name][0]["specs"]
    init = gangs["ranks"][name][0]["init"]
    assert specs["layers/attn/wq"][2] == "model"
    assert init["layers"]["attn"]["wq"].shape[1:3] == (64 // fsdp, 4 // tp)
    assert init["lm_head"].shape == (64 // fsdp, 256 // tp)
    assert init["embed"].shape == (256 // tp, 64 // fsdp)
    assert init["layers"]["attn"]["wk"].shape[2] == (2 // tp if tp <= 2
                                                      else 2)


def _state_specs(specs: dict) -> dict:
    out = {}
    for p, s in specs.items():
        for pre in ("params/", "opt_state/mu/", "opt_state/nu/"):
            out[pre + p] = s
    return out


@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_sharded_init_is_the_one_process_draw(gangs, world, name):
    got = whole_tree(gangs["ranks"][name], lambda r: r["init"])
    for p, w in T.flatten(gangs["init"]).items():
        assert torch.equal(got[p], w), p


@pytest.mark.parametrize("mesh", [None, {"model": 4}],
                         ids=["world1", "model4"])
def test_checkpoint_split_on_two_dims_restores_bit_for_bit(gangs, mesh):
    """The ``{fsdp: 2, model: 2}`` run's step-2 checkpoint (its leaves'
    blocks split on D over fsdp and on heads, columns or vocab over model)
    read whole at world 1, and on every rank of ``{model: 4}`` as that
    rank's blocks: the ranks' step-2 state assembled, bit for bit."""
    recs = gangs["ranks"][TP_CKPT_CASE]
    mgr = CheckpointManager(str(gangs["out"][4] / "ckpt"))
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
    if mesh is None:
        layouts = [None]
        sizes = coords = None
    else:
        sizes = {a: 1 for a in MESH_AXES}
        sizes.update(mesh)
        params = T.unflatten({p[len("params/"):]: t for p, t in whole.items()
                              if p.startswith("params/")})
        specs = _state_specs(T.flatten(shard_params(
            params, decoder_param_specs(preset("tiny")), sizes)))
        layouts = [ShardLayout(sizes, c, specs, rank=i, world=4)
                   for i, c in enumerate(all_coords(sizes, MESH_AXES))]
    for lay in layouts:
        got = T.flatten(mgr.restore(2, layout=lay))
        assert got["step"] == 2 and got["opt_state/count"] == 2
        for p, w in whole.items():
            want = w if lay is None else cut_local(
                w, lay.specs.get(p, ()), lay.sizes, lay.coords)
            assert torch.equal(got[p], want), (mesh, p)


#: The entry points' configs on a model axis: ``vision_train`` trains CLIP
#: with both towers in fp32 (the ``image`` entry of ``model_overrides``),
#: as bf16's rounding would move the split products past the 1e-5 check.
TP_ENTRY_CONFIGS = dict(ENTRY_CONFIGS, vision_train={
    **ENTRY_CONFIGS["vision_train"],
    "model_overrides": {"dtype": "float32", "image": {"dtype": "float32"}}})


@pytest.mark.parametrize("name", list(ENTRY_CONFIGS))
def test_entry_points_on_a_model_axis(tmp_path, name):
    """``llm_pretrain`` and ``vision_train`` train on ``{model: 2}``
    through two ``worker_main`` processes (the vision loss of the first
    step that of one process on the same batch), and ``torch_train``
    (data-parallel, no mesh) runs beside such a parallelism."""
    dirs = entry_dirs(tmp_path, name, 2)
    procs = spawn_gang(name, TP_ENTRY_CONFIGS[name], 2, dirs,
                       parallelism={"model": 2})
    res = finish(procs, timeout=180)
    assert [rc for rc, _, _ in res] == [0, 0], [e[-3000:] for *_, e in res]
    check_gang(name, 2, TP_ENTRY_CONFIGS[name], dirs)


# -- the vocab-parallel CE's plain forms, in one process -----------------------

@pytest.mark.parametrize("v,shards,softcap", [(1000, 4, None),
                                              (2056, 4, 30.0),
                                              (520, 2, None),
                                              (264, 3, None)])
def test_vocab_parallel_ce_matches_the_reference(v, shards, softcap):
    """Shards of V / n columns (250, 514, 260, 88: none a multiple of the
    256-column tile): nll, lse, accuracy and both gradients of the
    lockstep fused CE (its kernels' plain versions) and of the logits form
    (``vocab_parallel_ce``'s combine) against ``reference_cross_entropy``
    and autograd through it. A tie across a shard boundary goes to the
    lower column, a target outside the vocabulary picks nothing."""
    g = torch.Generator().manual_seed(v)
    t_, d = 40, 24
    h = torch.randn(t_, d, generator=g)
    w = torch.randn(d, v, generator=g) * d ** -0.5
    tgt = torch.randint(0, v, (t_,), generator=g)
    edge = v // shards
    w[:, edge + 1] = w[:, edge - 1]
    h[3] = h[4] = 6.0 * w[:, edge - 1]
    tgt[3], tgt[4] = edge - 1, edge + 1
    tgt[5] = v + 2
    cot = torch.rand(t_, generator=g)

    hr, wr = h.clone().requires_grad_(), w.clone().requires_grad_()
    nll, correct = fx.reference_cross_entropy(hr, wr, tgt,
                                              logits_softcap=softcap)
    dh, dw = torch.autograd.grad(nll, (hr, wr), cot)
    s = fx._logits_ref(h, w, softcap)
    lse = torch.logsumexp(s, -1)
    assert correct[3] == 1.0 and correct[4] == 0.0

    tn, tl, tc, tdh, tdw = vp.vocab_parallel_lockstep(
        h, w, tgt.to(torch.int32), shards, softcap, g=cot)
    for got, want in ((tn, nll), (tl, lse), (tdh, dh), (tdw, dw)):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(tc, correct)
    assert float(tn[5]) == float(tl[5])

    # The logits form: each shard's statistics, combined.
    stats = torch.stack([vp.logit_stats(s[:, r * edge:(r + 1) * edge],
                                        tgt - r * edge)
                         for r in range(shards)])
    cn, cl, cc = vp.combine_shards(stats)
    assert torch.allclose(cn, nll.detach(), rtol=1e-5, atol=1e-6)
    assert torch.allclose(cl, lse, rtol=1e-5, atol=1e-6)
    assert torch.equal(cc, correct)
