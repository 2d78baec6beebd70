"""The port's RMSNorm backward (``rmsnorm_bwd``) on the CPU against the JAX
package's fused RMSNorm backward, and the launch geometry of its kernels.

- ``rmsnorm_bwd`` takes its plain version on the CPU; it is held against
  ``jax.vjp`` of ``kubeflow_tpu.ops.fused_norm.rmsnorm_fused`` (no ``dy``)
  and ``add_rmsnorm_fused`` (with ``dy``, the residual stream's
  cotangent), whose Pallas backward runs in interpret mode as the JAX
  package's own tests run it. T of 1, 300 and 4097 (multiples of no
  rows-per-program), D of 1160 and 2048, with and without ``plus_one``;
  fp32, dx and dw within 1e-5 times the larger of 1 and the reference's
  largest magnitude (the tolerance of the fused norms in
  ``tests/test_torch_fused_train.py``).
- The explainer's shapes: T = 37 (a prompt length, a multiple of no tile),
  D = 4096, everything bf16 (serving weights) and the weight needing no
  gradient. The plain backward against the JAX backward within one bf16
  rounding of the reference (2^-7 relative) beside the fp32 floor; the
  norm and SwiGLU ``autograd.Function``s then return no gradient for an
  input that needs none and the input gradient of the JAX ``vjp``.
- ``rms_bwd_grid``: the row pass's programs take every row exactly once,
  its dw scratch stays within ``RMS_BWD_PER_SM`` x SMs x D x 4 bytes, and
  the column strips of the dw sum cover D exactly once, with a tile of
  rows that holds every program's partial.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from kubeflow_tpu.ops import fused_norm as jnorm  # noqa: E402
from kubeflow_tpu_torch.ops import fused_norm as tnorm  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

ATOL = 1e-5


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    err = float(np.max(np.abs(got.numpy() - want)))
    scale = max(1.0, float(np.max(np.abs(want))))
    assert err <= ATOL * scale, \
        f"{what}: max abs err {err:.3e} > {ATOL} x {scale:.3g}"


@pytest.mark.parametrize("residual", [False, True], ids=["no_dy", "dy"])
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("d", [1160, 2048])
@pytest.mark.parametrize("t", [1, 300, 4097])
def test_rmsnorm_bwd_matches_the_jax_backward(t, d, plus_one, residual):
    rng = np.random.default_rng(t * 7 + d)
    x, r, dh, dy = (rng.standard_normal((t, d)).astype(np.float32)
                    for _ in range(4))
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    eps = 1e-6
    if residual:
        _, vjp = jax.vjp(lambda x, r, w: jnorm.add_rmsnorm_fused(
            x, r, w, eps=eps, plus_one=plus_one, interpret=True), x, r, w)
        want_dx, _, want_dw = vjp((dy, dh))
        y = torch.tensor(x) + torch.tensor(r)
    else:
        _, vjp = jax.vjp(lambda x, w: jnorm.rmsnorm_fused(
            x, w, eps=eps, plus_one=plus_one, interpret=True), x, w)
        want_dx, want_dw = vjp(dh)
        y = torch.tensor(x)
    tw = torch.tensor(w)
    _, rstd = tnorm._rms_ref(y, tw, eps, plus_one)
    dx, dw = tnorm.rmsnorm_bwd(y, tw, rstd[:, 0], torch.tensor(dh),
                               plus_one=plus_one,
                               dy=torch.tensor(dy) if residual else None)
    assert dx.shape == (t, d) and dw.shape == (d,)
    assert dx.dtype == dw.dtype == torch.float32
    _close(dx, want_dx, "dx")
    _close(dw, want_dw, "dw")


BF16_RTOL = 2.0 ** -7


def _close_bf16(got: torch.Tensor, want, what: str, dy=None) -> None:
    """|got - want| <= 2^-7 |want| + ATOL x max(1, max |want|): the two
    sides reduce in fp32 in different orders and round once to bf16. With
    the residual cotangent ``dy`` there are two roundings: the norm's dx
    (|dx| <= |want| + |dy|) before ``dy`` is added, then the sum, so the
    bound is 2^-7 (2 |want| + |dy|)."""
    want = np.asarray(want, dtype=np.float32)
    g = got.float().numpy()
    scale = max(1.0, float(np.max(np.abs(want))))
    base = np.abs(want)
    if dy is not None:
        base = 2 * base + np.abs(np.asarray(dy, dtype=np.float32))
    bad = np.abs(g - want) > BF16_RTOL * base + ATOL * scale
    assert not bad.any(), \
        f"{what}: {int(bad.sum())} of {bad.size} outside one bf16 rounding"


def _bf16(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(jnp_bf16())


def jnp_bf16():
    import jax.numpy as jnp

    return jnp.bfloat16


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("residual", [False, True], ids=["no_dy", "dy"])
def test_rmsnorm_bwd_at_the_explain_shape_bf16(residual):
    """The backward alone, both sides given the same saved residuals (y,
    w, rstd): XLA's CPU interpreter may keep the forward's bf16 residual
    add in fp32 before the variance, so the two forwards' rstd can differ
    in their last bits, which is not the backward's doing."""
    t, d, eps = 37, 4096, 1e-5
    rng = np.random.default_rng(37)
    x, r, dh, dy = (_bf16(rng, t, d) for _ in range(4))
    w = (1.0 + _bf16(rng, d, scale=0.1).astype(np.float32)).astype(
        jnp_bf16())
    y = _t(x) + _t(r) if residual else _t(x)
    _, rstd = tnorm._rms_ref(y, _t(w), eps, False)
    jy = np.asarray(y.float().numpy()).astype(jnp_bf16())
    jres = (jy, np.asarray(w).reshape(1, d), rstd.numpy())
    br = jnorm._norm_blocks(t, None)
    if residual:
        want_dx, _, want_dw = jnorm._add_rmsnorm_vjp_bwd(
            eps, False, br, True, jres, (dy, dh))
    else:
        want_dx, want_dw = jnorm._rmsnorm_vjp_bwd(eps, False, br, True,
                                                  jres, dh)
    dx, dw = tnorm.rmsnorm_bwd(y, _t(w), rstd[:, 0], _t(dh),
                               dy=_t(dy) if residual else None)
    assert dx.dtype == dw.dtype == torch.bfloat16
    _close_bf16(dx, want_dx, "dx", dy if residual else None)
    _close_bf16(dw, np.asarray(want_dw).reshape(d), "dw")
    dx2, no_dw = tnorm.rmsnorm_bwd(y, _t(w), rstd[:, 0], _t(dh),
                                   dy=_t(dy) if residual else None,
                                   need_dw=False)
    assert no_dw is None and torch.equal(dx2, dx)


def test_autograd_functions_give_no_grad_to_serving_weights():
    """The explainer's backward: activations need a gradient, the bf16
    weights do not. Each Function returns None for the weight (it keeps no
    ``.grad``) and the activations' gradients equal the JAX ``vjp``'s."""
    t, d, m, eps = 37, 4096, 512, 1e-5
    rng = np.random.default_rng(38)
    x, r, dh = (_bf16(rng, 1, t, d) for _ in range(3))
    w = (1.0 + _bf16(rng, d, scale=0.1).astype(np.float32)).astype(
        jnp_bf16())
    g, u, do = (_bf16(rng, 1, t, m) for _ in range(3))

    tx, tw = _t(x).requires_grad_(True), _t(w)
    out = tnorm._RMSNormFn.apply(tx, tw, eps, False)
    (got,) = torch.autograd.grad(out, tx, _t(dh))
    _, vjp = jax.vjp(lambda x: jnorm.rmsnorm_fused(
        x, w, eps=eps, interpret=True), x)
    _close_bf16(got, vjp(dh)[0], "rmsnorm dx")
    assert tw.grad is None

    tx, tr = _t(x).requires_grad_(True), _t(r).requires_grad_(True)
    y, h = tnorm._AddRMSNormFn.apply(tx, tr, tw, eps, False)
    gx, gr = torch.autograd.grad((y, h), (tx, tr), (_t(dh), _t(dh)))
    _, vjp = jax.vjp(lambda x, r: jnorm.add_rmsnorm_fused(
        x, r, w, eps=eps, interpret=True), x, r)
    want_x, want_r = vjp((dh, dh))
    _close_bf16(gx, want_x, "add_rmsnorm dx", dh)
    _close_bf16(gr, want_r, "add_rmsnorm dres", dh)
    assert tw.grad is None

    tg, tu = _t(g).requires_grad_(True), _t(u)
    o = tnorm._SwiGLUFn.apply(tg, tu, "silu")
    (dg,) = torch.autograd.grad(o, tg, _t(do))
    _, vjp = jax.vjp(lambda g: jnorm.swiglu_fused(g, u, act="silu",
                                                  interpret=True), g)
    _close_bf16(dg, vjp(do)[0], "swiglu dgate")
    assert tu.grad is None


@pytest.mark.parametrize("rows,d,sms,per_sm", [
    (1, 4096, 132, 2), (7, 2048, 132, 2), (131, 1160, 132, 1),
    (300, 3072, 132, 2), (4096, 4096, 132, 2), (4097, 4096, 132, 3),
    (4096, 4096, 132, 1), (65536, 8192, 132, 2), (1000, 1, 16, 4),
    (0, 64, 132, 2)])
def test_rms_bwd_grid_covers_rows_and_columns_once(rows, d, sms, per_sm):
    progs, strips, tile = tnorm.rms_bwd_grid(rows, d, sms, per_sm)
    # Program p takes rows p, p + progs, ...: each row exactly once.
    taken = np.concatenate([np.arange(p, rows, progs) for p in range(progs)])
    assert np.array_equal(np.sort(taken), np.arange(rows))
    # The dw scratch: progs rows of d fp32, bounded by RMS_BWD_PER_SM per SM.
    assert 1 <= progs <= max(1, min(per_sm, tnorm.RMS_BWD_PER_SM)) * sms
    assert progs * d * 4 <= tnorm.RMS_BWD_PER_SM * sms * d * 4
    assert progs == max(1, min(rows, min(per_sm, tnorm.RMS_BWD_PER_SM) * sms))
    # Column strips cover [0, d) exactly once; the tile holds every
    # program's partial and is a power of two (tl.arange's rule).
    cols = np.concatenate([np.arange(s * tnorm.RMS_DW_COLS,
                                     min((s + 1) * tnorm.RMS_DW_COLS, d))
                           for s in range(strips)])
    assert np.array_equal(cols, np.arange(d))
    assert tile >= progs and tile & (tile - 1) == 0 and tile < 2 * progs + 1


def test_rms_bwd_grid_at_the_training_shape():
    """T = D = 4096 on 132 SMs holding two programs each: 264 programs
    (two rows in flight on every SM), a 4.3 MB scratch, and 128 strips of
    32 columns over a 512-row tile."""
    progs, strips, tile = tnorm.rms_bwd_grid(4096, 4096, 132, 2)
    assert (progs, strips, tile) == (264, 128, 512)
    assert progs * 4096 * 4 == 4325376
