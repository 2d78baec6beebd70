"""MoE training in the port against the JAX package, on the CPU at fp32,
``tiny-moe`` weights carried across by ``convert.params_from_jax``:

- ``decoder_loss`` (``ce + aux_loss_weight * aux``, the balance loss summed
  over the layers) and every gradient leaf against ``jax.value_and_grad``
  of JAX's ``decoder_loss``: dispatch and dense expert paths, remat
  ``none`` and ``nothing_saveable``, dense and chunked CE,
  ``aux_loss_weight`` 0.01 and 0 — loss within 1e-5, each leaf within
  1e-5 of its largest magnitude, as ``test_torch_train.py`` holds them;
- the reference's own MoE checks as parity: the dispatch block's gradients
  (zero-drop capacity) equal the dense block's and JAX's
  (``tests/test_moe_dispatch.py::test_dispatch_gradients_match_dense``),
  and ``decoder_loss`` at the training capacity factor gives JAX's loss
  and finite, nonzero gradients (``::test_decoder_loss_trains_with_dispatch``);
- a five-step ``Trainer`` run from JAX's initial state: every step's loss
  and ``aux_loss`` within 1e-3 of the JAX step's, ``aux_loss`` in
  ``metrics.jsonl``, and five steps with ``fused_kernels="on"`` (the fused
  norms and CE through their plain CPU paths) tracking five ``"off"``;
- the int8 repair: one MoE forward (dispatch and dense) dequantizes at
  most one expert's weight matrix at a time, and the quantized draw holds
  its pack bit for bit.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.models import layers as jlayers  # noqa: E402
from kubeflow_tpu.runtime.mesh import build_mesh  # noqa: E402
from kubeflow_tpu.train import data as jdata  # noqa: E402
from kubeflow_tpu.train import optim as joptim  # noqa: E402
from kubeflow_tpu.train import step as jstep  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models import decoder as tdec  # noqa: E402
from kubeflow_tpu_torch.models import layers as tlayers  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    opt_state_from_jax, params_from_jax,
)
from kubeflow_tpu_torch.ops import quantization as Q  # noqa: E402
from kubeflow_tpu_torch.train import step as tstep  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from kubeflow_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig,
)
from port_threads import torch_on_one_thread  # noqa: E402,F401

TOL = 1e-5


def _cfgs(**over):
    over = {"dtype": "float32", "fused_kernels": "off", **over}
    return (jconfig.preset("tiny-moe", **over),
            tconfig.preset("tiny-moe", **over))


def _np(tree):
    return jax.tree.map(np.array, tree)


def _rel_leaf_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


# -- decoder_loss ---------------------------------------------------------------

_JAX_LOSS: dict = {}


def _jax_loss(impl, chunk):
    """JAX's loss, metrics and grads at aux_loss_weight 0.01 and 0, on one
    init and one batch (one compile per expert path and CE branch)."""
    if (impl, chunk) not in _JAX_LOSS:
        jcfg, _ = _cfgs(moe_impl=impl, loss_chunk_size=chunk)
        params = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
        toks = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (2, 33)).astype(np.int32)

        def both(p):
            return tuple(jax.value_and_grad(
                lambda q: jdec.decoder_loss(q, toks, jcfg,
                                            aux_loss_weight=w),
                has_aux=True)(p) for w in (0.01, 0.0))

        got = jax.jit(both)(params)
        _JAX_LOSS[impl, chunk] = (_np(params), toks, {
            w: (float(loss), {k: float(v) for k, v in m.items()}, _np(g))
            for w, ((loss, m), g) in zip((0.01, 0.0), got)})
    return _JAX_LOSS[impl, chunk]


@pytest.mark.parametrize("weight", [0.01, 0.0])
@pytest.mark.parametrize("remat", ["none", "nothing_saveable"])
@pytest.mark.parametrize("chunk", [0, 16], ids=["dense_ce", "chunked_ce"])
@pytest.mark.parametrize("impl", ["dispatch", "dense"])
def test_moe_decoder_loss_and_grads_match_jax(impl, chunk, remat, weight):
    jparams, toks, runs = _jax_loss(impl, chunk)
    jloss, jm, jgrads = runs[weight]
    _, cfg = _cfgs(moe_impl=impl, loss_chunk_size=chunk, remat_policy=remat)
    params = tstep.trainable({"params": params_from_jax(
        jparams, device="cpu")})["params"]
    loss, m = tdec.decoder_loss(params, torch.from_numpy(toks), cfg,
                                aux_loss_weight=weight)
    assert abs(loss.item() - jloss) <= TOL
    for k in ("ce_loss", "aux_loss", "tokens", "accuracy"):
        assert abs(float(m[k]) - jm[k]) <= TOL, k
    assert jm["aux_loss"] > 2.0     # near k = 2 per layer at a uniform router
    grads = torch.autograd.grad(loss, T.leaves(params))
    want = T.flatten(params_from_jax(jgrads, device="cpu"))
    for (path, w), g in zip(want.items(), grads):
        err = _rel_leaf_err(g.numpy(), w.numpy())
        assert err <= TOL, f"{path}: {err:.2e}"


# -- the reference's own MoE checks, as parity ---------------------------------

def test_dispatch_gradients_match_dense_and_jax():
    """``sum(out²) + 0.01·aux`` of one block at zero-drop capacity (factor
    E): the dispatch path's gradients (router, gate, up, down and x) equal
    the dense path's with JAX's tolerances, and each equals JAX's."""
    jcfg, tcfg = _cfgs(capacity_factor=8.0)
    jp, _ = jlayers.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (2, 16, 64),
                                   jnp.float32))
    got = {}
    for impl in ("dispatch", "dense"):
        jc = dataclasses.replace(jcfg, moe_impl=impl)
        tc = dataclasses.replace(tcfg, moe_impl=impl)

        def jl(p, xx, jc=jc):
            out, aux = jlayers.moe_block(p, xx, jc)
            return jnp.sum(out ** 2) + 0.01 * aux

        jg = jax.grad(jl, argnums=(0, 1))(jp, jnp.asarray(x))
        tp = params_from_jax(_np(jp), device="cpu")
        for t in tp.values():
            t.requires_grad_(True)
        tx = torch.from_numpy(x).requires_grad_(True)
        out, aux = tlayers.moe_block(tp, tx, tc)
        names = ("router", "gate", "up", "down")
        grads = torch.autograd.grad((out ** 2).sum() + 0.01 * aux,
                                    [tp[n] for n in names] + [tx])
        got[impl] = dict(zip(names + ("x",), grads))
        for n in names:
            assert _rel_leaf_err(got[impl][n], jg[0][n]) <= TOL, (impl, n)
        assert _rel_leaf_err(got[impl]["x"], jg[1]) <= TOL, (impl, "x")
    for n, g in got["dispatch"].items():
        np.testing.assert_allclose(g.numpy(), got["dense"][n].numpy(),
                                   rtol=5e-5, atol=1e-5, err_msg=n)


def test_decoder_loss_trains_with_dispatch():
    """At the training capacity factor (1.25, drops possible): JAX's loss,
    a finite nonzero gradient sum, and JAX's gradient sum."""
    jcfg, tcfg = _cfgs(moe_impl="dispatch", capacity_factor=1.25)
    params = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 17), 0,
                                       jcfg.vocab_size))
    jloss, jg = jax.value_and_grad(
        lambda p: jdec.decoder_loss(p, toks, jcfg)[0])(params)
    tp = tstep.trainable({"params": params_from_jax(
        _np(params), device="cpu")})["params"]
    loss, _ = tdec.decoder_loss(tp, torch.from_numpy(toks).long(), tcfg)
    assert torch.isfinite(loss) and abs(loss.item() - float(jloss)) <= TOL
    grads = torch.autograd.grad(loss, T.leaves(tp))
    gn = sum(float(g.abs().sum()) for g in grads)
    jgn = jax.tree.reduce(lambda a, b: a + float(jnp.sum(jnp.abs(b))),
                          jg, 0.0)
    assert np.isfinite(gn) and gn > 0
    assert abs(gn - jgn) <= 1e-4 * jgn


# -- the trainer -----------------------------------------------------------------

_OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=5)
_DATA = dict(seq_len=32, global_batch=4)
_JAX_RUN: dict = {}


def _jax_run():
    """JAX's ``setup_train`` on ``tiny-moe``: its initial state (numpy) and
    five steps' losses and aux losses."""
    if not _JAX_RUN:
        jcfg, _ = _cfgs()
        task = jstep.setup_train(jcfg, joptim.OptimizerConfig(**_OPT),
                                 build_mesh({"fsdp": 1}, jax.devices()[:1]))
        init = _np(task.state)
        src = jdata.SyntheticLM(jdata.DataConfig(vocab_size=256, **_DATA))
        state, losses, auxs = task.state, [], []
        for i in range(5):
            state, m = task.step_fn(
                state, jax.device_put(src.batch_at(i), task.batch_sharding))
            losses.append(float(m["loss"]))
            auxs.append(float(m["aux_loss"]))
        _JAX_RUN.update(init=init, losses=losses, auxs=auxs)
    return _JAX_RUN


def _trainer(tmp_path, fused: str, init):
    tmp_path.mkdir()
    cfg = TrainerConfig(model="tiny-moe", model_overrides={
        "dtype": "float32", "fused_kernels": fused}, data=dict(_DATA),
        optimizer=dict(_OPT), steps=5, log_every=1, watchdog_enabled=False)
    tr = Trainer(cfg, device="cpu", workdir=str(tmp_path),
                 metrics_path=str(tmp_path / "metrics.jsonl"))
    tr.emitter.stream = io.StringIO()
    tr.task.state = tstep.trainable({
        "params": params_from_jax(init["params"], device="cpu"),
        "opt_state": opt_state_from_jax(init["opt_state"], device="cpu"),
        "step": int(init["step"])})
    seen = {}
    tr.run(on_step=lambda s, m: seen.__setitem__(s, dict(m)))
    return seen


def test_trainer_tracks_jax_and_fused_tracks_plain(tmp_path):
    """Five ``Trainer`` steps from JAX's initial state: losses and
    ``aux_loss`` within 1e-3 of JAX's (fp32 differences Adam grows step by
    step), ``aux_loss`` near k = 2 and written to ``metrics.jsonl``; five
    steps with ``fused_kernels="on"`` within 1e-5 of the plain run."""
    run = _jax_run()
    runs = {fk: _trainer(tmp_path / fk, fk, run["init"])
            for fk in ("off", "on")}
    off = runs["off"]
    assert sorted(off) == list(range(1, 6))
    for s in range(1, 6):
        assert abs(off[s]["loss"] - run["losses"][s - 1]) <= 1e-3, s
        assert abs(off[s]["aux_loss"] - run["auxs"][s - 1]) <= 1e-3, s
        # Each layer's balance loss lies near k = 2 at a near-uniform
        # router; aux_loss sums the two layers'.
        assert 3.0 < off[s]["aux_loss"] < 5.0
        assert abs(runs["on"][s]["loss"] - off[s]["loss"]) <= 1e-5, s
        assert abs(runs["on"][s]["aux_loss"] - off[s]["aux_loss"]) <= 1e-5
    lines = [json.loads(x) for x in
             (tmp_path / "off" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3, 4, 5]
    assert all(x["aux_loss"] == off[x["step"]]["aux_loss"] for x in lines)


# -- the int8 repair --------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dispatch", "dense"])
def test_int8_moe_forward_dequantizes_one_expert_at_a_time(impl, monkeypatch):
    """Every dequantized tensor of one int8 MoE block forward is at most
    one expert's weight matrix (D × M), and the output is the stacked
    dequant's."""
    _, tc = _cfgs(moe_impl=impl)
    gen = torch.Generator().manual_seed(0)
    p = tlayers.init_moe(gen, tc)
    qp = {k: v if k == "router" else Q.quantize_weight(v, (1,))
          for k, v in p.items()}
    x = torch.randn((2, 12, tc.hidden), generator=gen)
    sizes = []
    orig = Q.QuantizedTensor.dequant

    def recorded(self, dt):
        out = orig(self, dt)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(Q.QuantizedTensor, "dequant", recorded)
    with torch.no_grad():
        got, aux = tlayers.moe_block(qp, x, tc)
    monkeypatch.undo()
    assert sizes and max(sizes) <= tc.hidden * tc.mlp_dim
    whole = {k: v if k == "router" else v.dequant(torch.float32)
             for k, v in qp.items()}
    with torch.no_grad():
        want, waux = tlayers.moe_block(whole, x, tc)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert float(aux) == float(waux)


def test_quantized_draw_and_chunked_pack_are_bit_exact(monkeypatch):
    """The draw that packs each leaf as it lands equals the pack of the
    full-dtype draw, and ``quantize_weight`` in slices (a small
    ``QUANT_CHUNK``) equals it whole."""
    _, tc = _cfgs()
    plain = tdec.init_decoder_params(torch.Generator().manual_seed(3), tc)
    qp = tdec.init_decoder_params(torch.Generator().manual_seed(3), tc,
                                  quantize="int8")
    want = Q.quantize_params_int8(plain, tc)
    monkeypatch.setattr(Q, "QUANT_CHUNK", 1000)
    sliced = Q.quantize_params_int8(plain, tc)
    for tree in (qp, sliced):
        fa, fb = T.flatten(tree), T.flatten(want)
        assert list(fa) == list(fb)
        for k in fa:
            a, b = fa[k], fb[k]
            if isinstance(b, Q.QuantizedTensor):
                assert torch.equal(a.q, b.q) and torch.equal(a.scale,
                                                             b.scale), k
            else:
                assert torch.equal(a, b), k
