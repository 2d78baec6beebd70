"""The port's fused training kernels' plain versions and autograd wiring
against the JAX package's fused kernels, on the CPU at fp32.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_fused_kernels.py`` runs them, and differentiates them with
``jax.grad``/``jax.vjp`` through their custom VJPs. The port's side is the
CPU path of its ``torch.autograd.Function``s — the plain forward and
backward that ``chip_smoke.py`` holds the kernels against on the card —
through ``torch.autograd``.

- ``fused_cross_entropy`` (softcap off and 5.0): nll within 1e-5,
  ``correct`` exactly equal (a constructed argmax tie included), d_hidden
  and d_head within 1e-5; a zero loss mask gives exactly zero d_hidden
  rows; odd shapes (T=15, D=24, V=100) give nll within 1e-5; a target
  outside the vocab picks nothing (nll = lse), as the TPU kernel does.
- ``rmsnorm_fused`` / ``add_rmsnorm_fused`` (with and without
  ``plus_one``) and ``swiglu_fused`` (silu, gelu): values and gradients
  within 1e-5 of ``jax.vjp`` of the JAX fused functions.
- ``decoder_loss`` on ``preset("tiny")`` with ``fused_kernels="on"`` on
  both sides, on weights carried across with ``params_from_jax``: loss,
  accuracy and every gradient leaf within 1e-5 (of the leaf's largest
  magnitude).
Tolerances: 1e-5 times the larger of 1 and the reference's largest
magnitude (fp32 products, reductions and tanh rounded in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.ops import fused_norm as jnorm  # noqa: E402
from kubeflow_tpu.ops import fused_xent as jxent  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models import decoder as tdec  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.ops import fused_norm as tnorm  # noqa: E402
from kubeflow_tpu_torch.ops import fused_xent as txent  # noqa: E402
from kubeflow_tpu_torch.train import step as tstep  # noqa: E402
from kubeflow_tpu_torch.train import tree as T  # noqa: E402

ATOL = 1e-5


def _close(got, want, what, atol=ATOL):
    """Max abs error within ``atol`` times the larger of 1 and the
    reference's largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = float(np.max(np.abs(np.asarray(got) - want)))
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    assert err <= atol * scale, \
        f"{what}: max abs err {err:.3e} > {atol} x {scale:.3g}"


# -- fused cross-entropy --------------------------------------------------------

def _ce_inputs(t, d, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * d ** -0.5).astype(np.float32)
    tg = rng.integers(0, v, t).astype(np.int32)
    g = rng.standard_normal(t).astype(np.float32)
    return h, w, tg, g


def _with_tie(h, w, tg):
    """Columns 3 and 40 equal and the maxima of rows 0 and 1; row 0
    targets 3 (argmax: correct) and row 1 targets 40 (not the lowest
    index: not correct)."""
    w = w.copy()
    h = h.copy()
    tg = tg.copy()
    w[:, 40] = w[:, 3]
    h[0] = h[1] = 6.0 * w[:, 3] / np.linalg.norm(w[:, 3])
    tg[0], tg[1] = 3, 40
    return h, w, tg


def _jax_ce(h, w, tg, g, cap):
    nll, correct = jxent.fused_cross_entropy(h, w, tg, logits_softcap=cap,
                                             interpret=True)
    dh, dw = jax.grad(lambda h, w: jnp.sum(jxent.fused_cross_entropy(
        h, w, tg, logits_softcap=cap, interpret=True)[0] * g),
        argnums=(0, 1))(h, w)
    return np.array(nll), np.array(correct), np.array(dh), np.array(dw)


def _torch_ce(h, w, tg, g, cap):
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    nll, correct = txent.fused_cross_entropy(th, tw, torch.tensor(tg),
                                             logits_softcap=cap)
    (nll * torch.tensor(g)).sum().backward()
    return nll, correct, th.grad, tw.grad


@pytest.mark.parametrize("cap", [None, 5.0])
@pytest.mark.parametrize("part", ["nll", "correct", "dh", "dw"])
def test_fused_ce_matches_the_jax_kernel(cap, part):
    h, w, tg, g = _ce_inputs(64, 32, 256, seed=1)
    h, w, tg = _with_tie(h, w, tg)
    want = dict(zip(("nll", "correct", "dh", "dw"),
                    _jax_ce(h, w, tg, g, cap)))
    got = dict(zip(("nll", "correct", "dh", "dw"),
                   _torch_ce(h, w, tg, g, cap)))
    if part == "correct":
        np.testing.assert_array_equal(got[part].numpy(), want[part])
        assert got[part][0] == 1.0 and got[part][1] == 0.0
    else:
        assert got[part].shape == want[part].shape
        _close(got[part], want[part], part)


def test_fused_ce_masked_rows_get_exactly_zero_d_hidden():
    h, w, tg, g = _ce_inputs(32, 16, 128, seed=2)
    mask = np.ones(32, np.float32)
    mask[[0, 7, 31]] = 0.0
    th = torch.tensor(h, requires_grad=True)
    nll, _ = txent.fused_cross_entropy(th, torch.tensor(w), torch.tensor(tg))
    m = torch.tensor(mask)
    ((nll * m).sum() / m.sum()).backward()
    assert torch.count_nonzero(th.grad[[0, 7, 31]]) == 0
    assert torch.count_nonzero(th.grad[1]) > 0
    dh = jax.grad(lambda h: jnp.sum(jxent.fused_cross_entropy(
        h, w, tg, interpret=True)[0] * mask) / mask.sum())(h)
    _close(th.grad, np.array(dh), "dh")


def test_fused_ce_odd_shapes_match_the_jax_kernel():
    h, w, tg, g = _ce_inputs(15, 24, 100, seed=3)
    nll, correct, dh, dw = _jax_ce(h, w, tg, g, None)
    got = _torch_ce(h, w, tg, g, None)
    _close(got[0], nll, "nll")
    np.testing.assert_array_equal(got[1].numpy(), correct)
    _close(got[2], dh, "dh")
    _close(got[3], dw, "dw")


def test_fused_ce_keeps_the_leading_shape_and_refuses_a_wrong_head():
    h, w, tg, _ = _ce_inputs(12, 16, 64, seed=4)
    nll, correct = txent.fused_cross_entropy(
        torch.tensor(h).reshape(3, 4, 16), torch.tensor(w),
        torch.tensor(tg, dtype=torch.int64).reshape(3, 4))
    assert nll.shape == correct.shape == (3, 4)
    assert nll.dtype == correct.dtype == torch.float32
    rn, rc = txent.reference_cross_entropy(
        torch.tensor(h), torch.tensor(w), torch.tensor(tg))
    _close(nll.reshape(-1), rn.numpy(), "nll vs the unfused oracle")
    assert torch.equal(correct.reshape(-1), rc)
    with pytest.raises(ValueError, match="does not match hidden"):
        txent.fused_cross_entropy(torch.tensor(h), torch.tensor(w.T),
                                  torch.tensor(tg))


def test_a_target_outside_the_vocab_picks_nothing():
    h, w, tg, g = _ce_inputs(8, 16, 64, seed=5)
    tg[2] = 64 + 3
    nll, lse, correct = txent.xent_fwd_ref(torch.tensor(h), torch.tensor(w),
                                           torch.tensor(tg))
    assert float(nll[2]) == float(lse[2]) and float(correct[2]) == 0.0
    jn, jc = jxent.fused_cross_entropy(h, w, tg, interpret=True)
    _close(nll, np.array(jn), "nll")
    np.testing.assert_array_equal(correct.numpy(), np.array(jc))
    # The out-of-vocab row's gradient is the softmax alone.
    dh, dw = txent.xent_bwd_ref(torch.tensor(h), torch.tensor(w),
                                torch.tensor(tg), lse, torch.tensor(g))
    jdh, jdw = jax.grad(lambda h, w: jnp.sum(jxent.fused_cross_entropy(
        h, w, tg, interpret=True)[0] * g), argnums=(0, 1))(h, w)
    _close(dh, np.array(jdh), "dh")
    _close(dw, np.array(jdw), "dw")


def test_fused_ce_wrappers_launch_nothing_on_the_cpu():
    h, w, tg, g = _ce_inputs(8, 16, 64, seed=7)
    counters = (txent.xent_fwd, txent.dh_kernel, txent.dw_kernel)
    for c in counters:
        c.launches = 0
    th = torch.tensor(h, requires_grad=True)
    nll, _ = txent.fused_cross_entropy(th, torch.tensor(w), torch.tensor(tg))
    nll.sum().backward()
    assert th.grad is not None
    assert all(c.launches == 0 for c in counters)


def test_forward_ranges_fill_the_card_in_few_waves():
    # T = 4096, V = 128256 at 132 slots (132 SMs of one block): 32 row
    # tiles of 128 and 501 vocab tiles of 256 in 4 ranges of 126 tiles,
    # one wave of 128 blocks.
    assert txent._tiles_per_range(4096, 128256, 132) == 126
    for rows, vocab in ((1, 1000), (300, 128256), (4096, 256000)):
        per = txent._tiles_per_range(rows, vocab, 132)
        n_tiles = -(-vocab // txent.TILE)
        ranges = -(-n_tiles // per)
        assert 1 <= per <= n_tiles and (ranges - 1) * per < n_tiles


# -- fused RMSNorm and SwiGLU ---------------------------------------------------

def _vjp_case(fn_jax, fn_torch, primals, cotangents):
    out, vjp = jax.vjp(fn_jax, *primals)
    jgrads = vjp(cotangents if len(cotangents) > 1 else cotangents[0])
    tp = [torch.tensor(p, requires_grad=True) for p in primals]
    tout = fn_torch(*tp)
    touts = tout if isinstance(tout, tuple) else (tout,)
    jouts = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(list(touts), [torch.tensor(c) for c in cotangents])
    for i, (a, b) in enumerate(zip(touts, jouts)):
        _close(a, np.array(b), f"output {i}")
    for i, (p, g) in enumerate(zip(tp, jgrads)):
        _close(p.grad, np.array(g), f"grad {i}")


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_fused_grads_match_jax(plus_one):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (0.5 + rng.random(48)).astype(np.float32)
    dh = rng.standard_normal((2, 5, 48)).astype(np.float32)
    _vjp_case(lambda x, w: jnorm.rmsnorm_fused(x, w, eps=1e-5,
                                               plus_one=plus_one,
                                               interpret=True),
              lambda x, w: tnorm.rmsnorm_fused(x, w, eps=1e-5,
                                               plus_one=plus_one),
              (x, w), (dh,))


@pytest.mark.parametrize("plus_one", [False, True])
def test_add_rmsnorm_fused_grads_match_jax(plus_one):
    rng = np.random.default_rng(11)
    x, r = (rng.standard_normal((9, 64)).astype(np.float32) for _ in range(2))
    w = (0.5 + rng.random(64)).astype(np.float32)
    dy, dh = (rng.standard_normal((9, 64)).astype(np.float32)
              for _ in range(2))
    _vjp_case(lambda x, r, w: jnorm.add_rmsnorm_fused(
                  x, r, w, eps=1e-6, plus_one=plus_one, interpret=True),
              lambda x, r, w: tnorm.add_rmsnorm_fused(
                  x, r, w, eps=1e-6, plus_one=plus_one),
              (x, r, w), (dy, dh))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_fused_grads_match_jax(act):
    rng = np.random.default_rng(12)
    g, u, do = (rng.standard_normal((3, 7, 40)).astype(np.float32) * 2
                for _ in range(3))
    _vjp_case(lambda g, u: jnorm.swiglu_fused(g, u, act=act, interpret=True),
              lambda g, u: tnorm.swiglu_fused(g, u, act=act),
              (g, u), (do,))


def test_norm_backward_rounds_dx_before_adding_the_stream_cotangent():
    """bf16 on the CPU: the residual norm's input gradient is bf16(dx)
    plus dy, rounded again, as the JAX package's ``_add_rmsnorm_vjp_bwd``
    computes it."""
    gen = torch.Generator().manual_seed(13)
    x, dh, dy = (torch.randn((4, 32), generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    w = torch.randn(32, generator=gen)
    _, rstd = tnorm._rms_ref(x, w, 1e-5, False)
    dx, dw = tnorm.rmsnorm_bwd(x, w, rstd[:, 0], dh, dy=dy)
    plain, _ = tnorm.rmsnorm_bwd(x, w, rstd[:, 0], dh)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert torch.equal(dx, (dy + plain).to(torch.bfloat16))


def test_norm_and_swiglu_wrappers_count_no_launch_on_the_cpu():
    x = torch.randn((4, 32), requires_grad=True)
    w = torch.ones(32, requires_grad=True)
    names = ("rmsnorm_fused", "add_rmsnorm_fused", "swiglu_fused",
             "rmsnorm_bwd", "swiglu_bwd")
    for n in names:
        getattr(tnorm, n).launches = 0
    y, h = tnorm.add_rmsnorm_fused(x, x * 2, w, eps=1e-5)
    out = tnorm.swiglu_fused(tnorm.rmsnorm_fused(h, w, eps=1e-5), y)
    out.sum().backward()
    assert x.grad is not None and w.grad is not None
    assert all(getattr(tnorm, n).launches == 0 for n in names)


@pytest.mark.parametrize("fn", ["rmsnorm_fused", "add_rmsnorm_fused",
                                "swiglu_fused"])
def test_norm_and_swiglu_need_no_graph_under_no_grad(fn):
    # Serving calls these under no_grad: the forward runs without the
    # autograd Function, with the same values as a call that records one.
    gen = torch.Generator().manual_seed(8)
    x, r = torch.randn((3, 32), generator=gen), torch.randn((3, 32),
                                                          generator=gen)
    w = torch.randn(32, generator=gen, requires_grad=True)
    call = {"rmsnorm_fused": lambda: (tnorm.rmsnorm_fused(x, w, eps=1e-5),),
            "add_rmsnorm_fused": lambda: tnorm.add_rmsnorm_fused(
                x, r, w, eps=1e-5, plus_one=True),
            "swiglu_fused": lambda: (tnorm.swiglu_fused(
                x, w.expand(3, 32), act="gelu"),)}[fn]
    graphed = call()
    with torch.no_grad():
        plain = call()
    assert all(t.grad_fn is not None for t in graphed[-1:])
    assert all(t.grad_fn is None and not t.requires_grad for t in plain)
    for a, b in zip(graphed, plain):
        assert torch.equal(a.detach(), b)


# -- decoder_loss with fused kernels on -----------------------------------------

_TINY = dataclasses.replace(jconfig.preset("tiny"), dtype="float32",
                            fused_kernels="on")


@pytest.fixture(scope="module")
def _jax_fused_loss():
    params = jdec.init_decoder_params(jax.random.PRNGKey(3), _TINY)
    toks = np.random.default_rng(3).integers(
        0, _TINY.vocab_size, (2, 33)).astype(np.int32)
    (loss, m), grads = jax.value_and_grad(
        lambda p: jdec.decoder_loss(p, toks, _TINY), has_aux=True)(params)
    return (jax.tree.map(np.array, params), toks, float(loss),
            {k: float(v) for k, v in m.items()},
            jax.tree.map(np.array, grads))


@pytest.mark.parametrize("what", ["loss", "grads"])
def test_decoder_loss_fused_on_matches_jax(_jax_fused_loss, what):
    jparams, toks, jloss, jm, jgrads = _jax_fused_loss
    fields = {f.name: getattr(_TINY, f.name)
              for f in dataclasses.fields(_TINY)}
    cfg = tconfig.DecoderConfig(**fields)
    params = tstep.trainable({"params": params_from_jax(
        jparams, device="cpu")})["params"]
    loss, m = tdec.decoder_loss(params, torch.from_numpy(toks), cfg)
    if what == "loss":
        assert abs(loss.item() - jloss) <= ATOL
        for k in ("ce_loss", "tokens", "accuracy"):
            assert abs(float(m[k]) - jm[k]) <= ATOL, k
        return
    grads = torch.autograd.grad(loss, T.leaves(params))
    want = T.flatten(params_from_jax(jgrads, device="cpu"))
    assert len(want) == len(grads)
    for (path, w), g in zip(want.items(), grads):
        scale = max(float(w.abs().max()), 1e-30)
        err = float((g - w).abs().max()) / scale
        assert err <= ATOL, f"{path}: {err:.2e}"
