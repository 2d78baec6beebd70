"""The port's seven remat policies against the JAX package's, on the CPU
at fp32 (``models/decoder.py``'s ``_remat`` beside
``kubeflow_tpu/models/decoder.py``'s):

- ``decoder_loss`` and every gradient leaf under each policy against
  ``jax.value_and_grad`` of JAX's ``decoder_loss`` under the same policy,
  on ``tiny`` (plain attention, and the flash path: JAX's kernels in
  interpret mode, the port's plain flash) and on ``tiny-moe`` (dispatch
  and dense experts): loss within 1e-5, each leaf within 1e-5 of its
  largest magnitude;
- what each policy keeps of one layer: the tensors a checkpoint holds as
  its inputs and the outputs the selective policy keeps (recorded from its
  own decisions), with ``saved_tensors_hooks`` showing that nothing else
  of the layer is saved. Their sizes equal ``_table``'s, and JAX's
  ``saved_residuals`` of the same layer equal those less the differences
  ``_jax_drops`` lists with their reasons;
- the flash forward's calls per loss and backward: a policy that keeps
  ``(o, lse)`` replays no flash forward;
- an unknown name raises ``ValueError`` in both packages;
- the vision trunk keeps its own rule (every policy but ``"none"``
  replays the whole block, in both packages): a tiny ViT under
  ``dots_flash`` has ``nothing_saveable``'s gradients, in both.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import checkpoint as tcheckpoint

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402

from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.models import vision as jvis  # noqa: E402
from kubeflow_tpu.train import vision_task as jtask  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models import decoder as tdec  # noqa: E402
from kubeflow_tpu_torch.models import layers as tlayers  # noqa: E402
from kubeflow_tpu_torch.models import vision as tvis  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.ops import flash_attention as F  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402
from kubeflow_tpu_torch.train.step import trainable  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

TOL = 1e-5
POLICIES = ("none", "full", "nothing_saveable", "dots_saveable",
            "dots_no_batch", "dots_flash", "block_outs")
#: name -> (preset, config overrides, attention impl)
VARIANTS = {
    "tiny-xla": ("tiny", {}, "xla"),
    "tiny-flash": ("tiny", {}, "pallas"),
    "moe-dispatch": ("tiny-moe", {"moe_impl": "dispatch"}, "xla"),
    "moe-dense": ("tiny-moe", {"moe_impl": "dense"}, "xla"),
}


def _np(tree):
    return jax.tree.map(np.array, tree)


def _rel_leaf_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def _cfgs(variant, **over):
    name, base, _ = VARIANTS[variant]
    over = {"dtype": "float32", "fused_kernels": "off", **base, **over}
    return jconfig.preset(name, **over), tconfig.preset(name, **over)


# -- loss and gradients ----------------------------------------------------------

_JAX: dict = {}


def _jax_run(variant):
    """JAX's loss and grads under every policy, one init and one batch."""
    if variant not in _JAX:
        attn = VARIANTS[variant][2]
        jcfg, _ = _cfgs(variant)
        params = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
        toks = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (2, 33)).astype(np.int32)

        def each(p):
            return tuple(jax.value_and_grad(
                lambda q, pol=pol: jdec.decoder_loss(
                    q, toks, dataclasses.replace(jcfg, remat_policy=pol),
                    attn_impl=attn)[0])(p) for pol in POLICIES)

        got = jax.jit(each)(params)
        _JAX[variant] = (_np(params), toks, {
            pol: (float(loss), _np(g)) for pol, (loss, g) in zip(POLICIES,
                                                                 got)})
    return _JAX[variant]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_jax(variant, policy):
    jparams, toks, runs = _jax_run(variant)
    jloss, jgrads = runs[policy]
    _, cfg = _cfgs(variant, remat_policy=policy)
    params = trainable({"params": params_from_jax(jparams, device="cpu")})[
        "params"]
    loss, _ = tdec.decoder_loss(params, torch.from_numpy(toks), cfg,
                                attn_impl=VARIANTS[variant][2])
    assert abs(loss.item() - jloss) <= TOL
    grads = torch.autograd.grad(loss, T.leaves(params))
    want = T.flatten(params_from_jax(jgrads, device="cpu"))
    for (path, w), g in zip(want.items(), grads):
        err = _rel_leaf_err(g.numpy(), w.numpy())
        assert err <= TOL, f"{path}: {err:.2e}"


# -- what each policy keeps ------------------------------------------------------

B, S = 2, 16


def _sizes(cfg) -> dict:
    """Elements of each tensor a layer may keep, at [B, S]."""
    t, d, m = B * S, cfg.hidden, cfg.mlp_dim
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {"x": t * d, "q": t * h * dh, "k": t * kh * dh, "v": t * kh * dh,
           "attn_out": t * d, "gate": t * m, "up": t * m, "down": t * d,
           "scores": B * h * S * S, "probs_v": B * h * S * dh,
           "flash_o": B * h * S * dh, "flash_lse": B * h * S}
    if cfg.is_moe:
        e, c = cfg.num_experts, tlayers.moe_capacity(cfg, t)
        out.update(router=t * e, expert_gate=e * c * m, expert_up=e * c * m,
                   expert_down=e * c * d, dense_gate=e * t * m,
                   dense_up=e * t * m, dense_down=e * t * d, combine_w=t * e,
                   combine=t * d)
    return out


def _table(variant: str, policy: str) -> list:
    """What the port keeps of a layer under ``policy``: the layer input and
    every product (``dots_saveable``), every product without batch
    dimensions (``dots_no_batch``), those and the flash kernel's ``(o,
    lse)`` (``dots_flash``), or the tensors between ``block_outs``'
    stages. ``mlp_out`` is a stage's output that no backward reads, so it
    is not kept (nor is it by JAX: a ``checkpoint_name`` saves only
    what the backward needs)."""
    name, over, attn = VARIANTS[variant]
    moe = over.get("moe_impl")
    if policy in ("full", "nothing_saveable"):
        return ["x"]
    if policy == "block_outs":
        return ["x", "q", "k", "v", "attn_out"]
    no_batch = ["x", "q", "k", "v", "attn_out"] + {
        None: ["gate", "up", "down"], "dispatch": ["router"],
        # torch.matmul folds the broadcast [1, T, D] @ [E, D, M] into one
        # mm, as JAX's "bsd,edm->ebsm" has no batch dimensions.
        "dense": ["router", "dense_gate", "dense_up"]}[moe]
    if policy == "dots_no_batch":
        return no_batch
    if policy == "dots_flash":
        return no_batch + (["flash_o", "flash_lse"] if attn == "pallas"
                           else [])
    assert policy == "dots_saveable"
    batched = ["scores", "probs_v"] if attn == "xla" else []
    batched += {None: [], "dispatch": ["expert_gate", "expert_up",
                                       "expert_down"],
                "dense": ["combine_w", "dense_down", "combine"]}[moe]
    return no_batch + batched


def _jax_drops(variant: str, policy: str) -> list:
    """What the port keeps and JAX's ``saved_residuals`` lack, and why:
    JAX drops a product its backward never reads (dead-code elimination
    after partial evaluation); PyTorch's selective checkpointing keeps
    every output its policy names, and replaying the op instead would cost
    the product again (one [T, M] x [M, D] GEMM per layer for ``down``)."""
    moe = VARIANTS[variant][1].get("moe_impl")
    drops = []
    if policy in ("dots_saveable", "dots_no_batch", "dots_flash") \
            and moe is None:
        drops.append("down")      # x + down: the add's backward reads neither
    if policy == "dots_saveable" and moe == "dense":
        drops.append("combine")   # "ebsd,bse->bsd", read by nothing
    return drops


def _port_kept(variant: str, policy: str):
    """The sizes of what one port layer keeps under ``policy`` (inputs of
    each checkpoint, outputs the selective policy keeps), and the tensors
    of the layer that an outer ``saved_tensors_hooks`` sees but are not
    among them (a checkpoint saves its inputs through autograd, every
    other tensor through its own hooks)."""
    _, cfg = _cfgs(variant, remat_policy=policy, n_layers=1)
    attn = VARIANTS[variant][2]
    params = tdec.init_decoder_params(torch.Generator().manual_seed(0), cfg)
    bp = trainable({"params": params})["params"]["layers"]
    bp = tdec.layer_view(bp, 0)
    x = torch.randn((B, S, cfg.hidden), requires_grad=True)
    pos = torch.arange(S)[None].expand(B, S)
    kept = {}
    saved = (tdec.checkpoint, tdec.create_selective_checkpoint_contexts)

    def checkpoint(fn, *args, **kw):
        for a in args:
            kept.setdefault(id(a), a)
        return saved[0](fn, *args, **kw)

    def contexts(policy_fn):
        def recording(ctx, op, *args, **kwargs):
            decision = policy_fn(ctx, op, *args, **kwargs)
            if (decision == tcheckpoint.CheckpointPolicy.MUST_SAVE
                    and not ctx.is_recompute):
                outs = ctx.op_output
                for o in (outs if isinstance(outs, tuple) else (outs,)):
                    kept.setdefault(id(o), o)
            return decision

        return saved[1](recording)

    packed = []
    tdec.checkpoint, tdec.create_selective_checkpoint_contexts = (
        checkpoint, contexts)
    try:
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: packed.append(t) or t, lambda t: t):
            y, _ = tdec._remat(tdec._block_stages(
                bp, pos, cfg, attn, None, None), policy)(x)
    finally:
        tdec.checkpoint, tdec.create_selective_checkpoint_contexts = saved
    assert y.shape == x.shape
    kept = [t for t in kept.values() if isinstance(t, torch.Tensor)]
    ids = {(t.data_ptr(), t.shape) for t in kept}
    return (sorted(int(t.numel()) for t in kept),
            [t for t in packed if (t.data_ptr(), t.shape) not in ids])


def _jax_kept(variant: str, policy: str) -> list:
    """The sizes of JAX's residuals of one layer under ``policy``: the
    layer input and every residual that is neither a weight nor a
    constant (positions, RoPE frequencies)."""
    jcfg, _ = _cfgs(variant)
    attn = VARIANTS[variant][2]
    params = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    bp = jax.tree.map(lambda t: t[0], params["layers"])
    x = jnp.ones((B, S, jcfg.hidden), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))

    def block(bp, x):
        y, _, aux = jdec._block_forward(bp, x, pos, jcfg, attn_impl=attn)
        return y.sum() + aux

    return sorted(int(np.prod(a.shape)) for a, why in saved_residuals(
        jdec._remat(block, policy), bp, x)
        if "from a constant" not in why
        and ("from the argument" not in why or "argument x" in why))


@pytest.mark.parametrize("policy", POLICIES[1:])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kept_tensors_follow_the_table_and_jax(variant, policy):
    _, cfg = _cfgs(variant)
    size = _sizes(cfg)
    want = sorted(size[n] for n in _table(variant, policy))
    got, outside = _port_kept(variant, policy)
    assert got == want, (got, want)
    assert not outside          # nothing else of the layer is saved
    jax_want = collections.Counter(want)
    jax_want.subtract(size[n] for n in _jax_drops(variant, policy))
    assert collections.Counter(_jax_kept(variant, policy)) == +jax_want


def test_none_keeps_every_activation():
    """``"none"`` is no checkpoint at all: the block's every saved tensor
    reaches the outer hooks, and nothing passes through a checkpoint."""
    kept, outside = _port_kept("tiny-xla", "none")
    assert kept == [] and len(outside) >= 10


# -- the flash forward under each policy -----------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_kept_flash_outputs_are_not_replayed(policy, monkeypatch):
    """Calls of the flash forward's implementation (on a card, each is a
    kernel launch) in one loss and backward of 2 layers: L where the
    policy keeps ``(o, lse)`` or keeps everything, 2L where the backward
    replays the layer; the backward op runs once a layer."""
    calls = collections.Counter()
    fwd, bwd = F._flash_fwd_impl, F._flash_bwd_impl

    def count(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(F, "_flash_fwd_impl", count("fwd", fwd))
    monkeypatch.setattr(F, "_flash_bwd_impl", count("bwd", bwd))
    _, cfg = _cfgs("tiny-flash", remat_policy=policy)
    params = trainable({"params": tdec.init_decoder_params(
        torch.Generator().manual_seed(0), cfg)})["params"]
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    loss, _ = tdec.decoder_loss(params, toks, cfg, attn_impl="pallas")
    torch.autograd.grad(loss, T.leaves(params))
    n = cfg.n_layers
    assert calls == {"fwd": n if policy in ("none", "dots_flash") else 2 * n,
                     "bwd": n}


@pytest.mark.parametrize("grad", [False, True])
def test_flash_attention_calls_the_dispatcher_op(grad):
    """Serving (no gradient) and training reach the flash forward through
    one route, ``kftpu_torch::flash_fwd``, which a policy can see."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        seen: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 4, 16), generator=g, requires_grad=grad)
    k, v = (torch.randn((1, 8, 2, 16), generator=g) for _ in range(2))
    with torch.set_grad_enabled(grad), Ops():
        F.flash_attention(q, k, v)
    assert Ops.seen.count(F.flash_fwd_op) == 1


# -- refusals and the vision trunk's rule ----------------------------------------

def test_unknown_policy_raises_in_both_packages():
    jcfg, tcfg = _cfgs("tiny-xla", remat_policy="save_everything_twice")
    with pytest.raises(ValueError, match="save_everything_twice"):
        jdec._remat(lambda x: x, jcfg.remat_policy)
    params = tdec.init_decoder_params(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="save_everything_twice"):
        tdec.decoder_loss(params, torch.zeros((1, 9), dtype=torch.long),
                          tcfg)


def test_vision_trunk_replays_the_block_under_dots_flash():
    """The vision trunk's own ``_remat`` in both packages: ``dots_flash``
    replays the whole block as ``nothing_saveable`` does, so both give the
    same gradients; the port's equal JAX's."""
    grads = {}
    for policy in ("nothing_saveable", "dots_flash"):
        over = {"dtype": "float32", "remat_policy": policy}
        jcfg = jvis.vit_preset("tiny-vit", **over)
        tcfg = tvis.vit_preset("tiny-vit", **over)
        jparams = jvis.init_vit_params(jax.random.PRNGKey(0), jcfg)
        batch = jtask.vit_batch(jcfg, 4, 1)
        jg = _np(jax.grad(lambda p: jvis.vit_loss(p, batch, jcfg)[0])(
            jparams))
        params = trainable({"params": params_from_jax(_np(jparams),
                                                      device="cpu")})[
            "params"]
        loss, _ = tvis.vit_loss(params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()}, tcfg)
        tg = torch.autograd.grad(loss, T.leaves(params))
        grads[policy] = (T.flatten(params_from_jax(jg, device="cpu")),
                         [g.numpy() for g in tg])
    (jn, tn), (jf, tf) = grads["nothing_saveable"], grads["dots_flash"]
    for (path, a), b in zip(jn.items(), jf.values()):
        assert _rel_leaf_err(b.numpy(), a.numpy()) <= TOL, path
    for a, b, (path, w) in zip(tn, tf, jf.items()):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert _rel_leaf_err(b, w.numpy()) <= TOL, path
