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
