"""The port's flash-attention backward against the JAX package's ``_flash``
custom VJP, on the same numpy inputs at fp32.

The JAX side runs with ``bwd_impl="xla"`` (the einsum oracle) and with
``bwd_impl="pallas"`` (the dK/dV and dQ kernels in interpret mode, as the
JAX package's own tests run them on the CPU). The port's side is the
plain backward ``flash_bwd_ref`` and the CPU path of ``FlashAttentionFn``
through ``torch.autograd`` — the same autograd wiring the kernels use on a
card. Shapes: B=1, H=4 over KH=2 and H=KH=4, (S, D) in {(64, 32), (128,
16)}, causal, softcap off and on. Tolerance: atol 1e-5 (fp32 products
summed in a different order)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops import flash_attention as jflash  # noqa: E402
from kubeflow_tpu_torch.ops import flash_attention as F  # noqa: E402

ATOL = 1e-5
CASES = [(kh, s, d, cap, impl)
         for kh in (2, 4)
         for s, d in ((64, 32), (128, 16))
         for cap in (None, 5.0)
         for impl in ("xla", "pallas")]
_REF: dict = {}


def _inputs(kh, s, d):
    rng = np.random.default_rng(1000 * kh + s + d)
    q = rng.standard_normal((1, 4, s, d)).astype(np.float32)
    k = rng.standard_normal((1, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((1, kh, s, d)).astype(np.float32)
    do = rng.standard_normal((1, 4, s, d)).astype(np.float32)
    return q, k, v, do


def _jax_case(kh, s, d, cap, impl):
    """(inputs, o, lse, (dq, dk, dv)) of the JAX custom VJP, kernel layout."""
    key = (kh, s, d, cap, impl)
    if key not in _REF:
        q, k, v, do = _inputs(kh, s, d)
        scale = d ** -0.5
        o, vjp = jax.vjp(
            lambda q, k, v: jflash._flash(q, k, v, True, scale, cap, 0, None,
                                          None, True, impl), q, k, v)
        _, lse = jflash._flash_fwd(q, k, v, causal=True, sm_scale=scale,
                                   softcap=cap, q_offset=0, block_q=None,
                                   block_kv=None, interpret=True)
        grads = [np.array(g) for g in vjp(jnp.asarray(do))]
        _REF[key] = ((q, k, v, do), np.array(o), np.array(lse), grads)
    return _REF[key]


def _assert_close(got, want, what):
    err = float(np.max(np.abs(np.asarray(got) - want)))
    assert err <= ATOL, f"{what}: max abs err {err:.3e} > {ATOL}"


@pytest.mark.parametrize("kh,s,d,cap,impl", CASES)
def test_flash_bwd_ref_matches_the_jax_vjp(kh, s, d, cap, impl):
    (q, k, v, do), o, lse, want = _jax_case(kh, s, d, cap, impl)
    got = F.flash_bwd_ref(*(torch.tensor(x) for x in (q, k, v, o, lse, do)),
                          causal=True, sm_scale=d ** -0.5, softcap=cap,
                          q_offset=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        _assert_close(g.numpy(), w, name)


@pytest.mark.parametrize("kh,s,d,cap,impl", CASES)
def test_flash_attention_autograd_matches_the_jax_vjp(kh, s, d, cap, impl):
    """``flash_attention`` ([B,S,H,D] layout) forward and backward through
    ``FlashAttentionFn`` on the CPU."""
    (q, k, v, do), o, lse, want = _jax_case(kh, s, d, cap, impl)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    out, tlse = F.flash_attention(tq, tk, tv, causal=True,
                                  logits_softcap=cap)
    _assert_close(out.detach().transpose(1, 2).numpy(), o, "o")
    _assert_close(tlse.numpy(), lse, "lse")
    assert not tlse.requires_grad
    out.backward(torch.from_numpy(do).transpose(1, 2))
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        _assert_close(t.grad.transpose(1, 2).numpy(), w, name)


def test_kernel_wrappers_take_the_plain_core_on_the_cpu():
    """``flash_bwd_dkdv`` and ``flash_bwd_dq`` on CPU tensors equal the
    plain backward's parts and launch nothing."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 64, 32))
    kw = dict(causal=True, sm_scale=32 ** -0.5, softcap=None, q_offset=0)
    o, lse = F.flash_ref(q, k, v, **kw)
    want = F.flash_bwd_ref(q, k, v, o, lse, do, **kw)
    delta = (do * o).sum(-1)
    before = (F.flash_bwd_dkdv.launches, F.flash_bwd_dq.launches)
    dk, dv = F.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = F.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert (F.flash_bwd_dkdv.launches, F.flash_bwd_dq.launches) == before


def test_fully_masked_rows_give_no_gradient():
    """A query row that sees no key (negative q_offset) has lse = NEG_INF
    and must get exactly zero dq, adding nothing to dk/dv."""
    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, 64, 16))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 16))
                             .astype(np.float32)) for _ in range(2))
    kw = dict(causal=True, sm_scale=0.25, softcap=None, q_offset=-5)
    o, lse = F.flash_ref(q, k, v, **kw)
    assert torch.all(lse[:, :, :5] <= F.NEG_INF / 2)
    dq, dk, dv = F.flash_bwd_ref(q, k, v, o, lse, do, **kw)
    assert torch.count_nonzero(dq[:, :, :5]) == 0
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    # The masked rows' cotangents do not move dk/dv.
    do2 = do.clone()
    do2[:, :, :5] = 100.0
    _, dk2, dv2 = F.flash_bwd_ref(q, k, v, o, lse, do2, **kw)
    torch.testing.assert_close(dk2, dk)
    torch.testing.assert_close(dv2, dv)


def test_kernel_launch_refuses_what_it_does_not_take():
    """The launch checks run before any build: CPU tensors, a head_dim
    outside (64, 128) and H % KH != 0 all raise."""
    q = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        F._launch_bwd("dq", q, k, k, q, lse, lse, causal=True, sm_scale=1.0,
                      softcap=None, q_offset=0)
    with pytest.raises(ValueError, match="head_dim"):
        F._check_shapes("t", q[..., :32], k[..., :32], k[..., :32])
    k3 = torch.zeros((1, 3, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        F._check_shapes("t", q, k3, k3)


# The kernels' tile edges (128-row tiles; 64-row q tiles in dK/dV): lengths
# 127 and 129, a diagonal that crosses a tile off its boundary (Sq = 200,
# Skv = 328, q_offset = 128) and a negative q_offset (rows that see no
# key), head_dim 64 and 128. (kh, sq, skv, d, q_offset, softcap, JAX
# (block_q, block_kv): blocks that divide the lengths where its
# _fit_block refuses them).
EDGE_CASES = [
    (2, 127, 127, 64, 0, None, (None, None)),
    (2, 129, 129, 128, 0, None, (129, 129)),
    (4, 129, 129, 64, 0, 5.0, (43, 43)),
    (2, 200, 328, 128, 128, None, (100, 82)),
    (2, 127, 127, 128, -5, None, (None, None)),
]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kh,sq,skv,d,off,cap,blocks", EDGE_CASES)
def test_flash_bwd_ref_matches_the_jax_vjp_at_kernel_edges(
        kh, sq, skv, d, off, cap, blocks, impl):
    rng = np.random.default_rng(sq + skv + d + off)
    q, do = (rng.standard_normal((1, 4, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, kh, skv, d)).astype(np.float32)
            for _ in range(2))
    scale = d ** -0.5
    bq, bkv = blocks
    o, vjp = jax.vjp(
        lambda q, k, v: jflash._flash(q, k, v, True, scale, cap, off, bq,
                                      bkv, True, impl), q, k, v)
    _, lse = jflash._flash_fwd(q, k, v, causal=True, sm_scale=scale,
                               softcap=cap, q_offset=off, block_q=bq,
                               block_kv=bkv, interpret=True)
    want = [np.array(g) for g in vjp(jnp.asarray(do))]
    kw = dict(causal=True, sm_scale=scale, softcap=cap, q_offset=off)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to, tlse = F.flash_ref(tq, tk, tv, **kw)
    _assert_close(to.numpy(), np.array(o), "o")
    _assert_close(tlse.numpy(), np.array(lse), "lse")
    got = F.flash_bwd_ref(tq, tk, tv, to, tlse, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        _assert_close(g.numpy(), w, name)
    if off < 0:
        assert torch.count_nonzero(got[0][:, :, :-off]) == 0


def test_tma_alignment_is_checked():
    """The forward and dK/dV kernels read q, k, v (and dO) through TMA
    tensor maps: such a tensor that does not start on a 16-byte boundary
    is refused before any launch; an aligned one passes."""
    base = torch.zeros(4 * 8 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:4 * 8 * 64].view(1, 4, 8, 64)
    shifted = base[1:1 + 4 * 8 * 64].view(1, 4, 8, 64)     # 2 bytes in
    qkv = {"q": aligned, "k": aligned, "v": aligned}
    F._check_tma("flash_attention", qkv)
    F._check_tma("flash_bwd_dkdv", {**qkv, "do": aligned})
    for name, bad in (("flash_attention", "k"), ("flash_bwd_dkdv", "do")):
        with pytest.raises(ValueError, match="16-byte"):
            F._check_tma(name, {**qkv, "do": aligned, bad: shifted})


def test_misaligned_lse_delta_and_dq_inputs_are_accepted():
    """lse and delta are read with plain loads (their rows start anywhere):
    neither backward kernel refuses them for their alignment, beside
    aligned q, k, v and dO."""
    base = torch.zeros(4 * 8 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:4 * 8 * 64].view(1, 4, 8, 64)
    rows = torch.zeros(4 * 8 + 1)[1:].view(1, 4, 8)         # 4 bytes in
    assert rows.data_ptr() % 16
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        F._check_tma(name, {"q": aligned, "k": aligned, "v": aligned,
                            "do": aligned, "lse": rows, "delta": rows})


@pytest.mark.parametrize("bad", ["q", "k", "v", "do"])
def test_misaligned_dq_tma_input_is_refused(bad):
    """The dQ kernel reads q and dO (its Q and dO tiles) and k and v (the
    streamed K/V ring) through TMA: each must start on a 16-byte boundary."""
    base = torch.zeros(4 * 8 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:4 * 8 * 64].view(1, 4, 8, 64)
    shifted = base[1:1 + 4 * 8 * 64].view(1, 4, 8, 64)     # 2 bytes in
    rows = torch.zeros(1, 4, 8)
    inputs = {"q": aligned, "k": aligned, "v": aligned, "do": aligned,
              "lse": rows, "delta": rows}
    with pytest.raises(ValueError, match="16-byte"):
        F._check_tma("flash_bwd_dq", {**inputs, bad: shifted})
