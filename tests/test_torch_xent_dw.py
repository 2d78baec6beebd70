"""The fused cross-entropy's d_head product (``xent_dw_kernel`` in
``kubeflow_tpu_torch/csrc/fused_xent.cu``) emulated in plain PyTorch on
the CPU at fp32, against the port's plain backward and the JAX package's
d_head kernel (Pallas in interpret mode, through ``jax.grad``).

The kernel cannot run here, so its walk is written out once more:

- per vocab chunk of ``chunk`` columns, the chunk's dl goes into a scratch
  [T, chunk] that the previous chunk filled, and dW_c [D, vc] = h^T dl_c is
  formed in output tiles of 128 rows of D by 256 chunk columns, in
  ``tile_at``'s grouped order over a persistent grid of ``min(tiles, 132)``
  blocks, each tile from K steps of 64 rows of T into one fp32
  accumulator; an operand box reads zeros past T, D and the chunk's last
  column (TMA's fill; the scratch's stale columns past a ragged chunk
  could reach only output columns that are not written), and the tile is
  cast to W's dtype once, rows past D and columns past vc unwritten. Every
  element of dW is written exactly once. Within 1e-6 (relative to the
  magnitude, at least 1) of ``xent_bwd_ref``'s dw and of ``jax.grad`` of
  the JAX ``fused_cross_entropy`` in W, at T in {1, 300}, D in {136, 256}
  and a whole chunk followed by a ragged one;
- a mirror of ``tile_at`` over the persistent grid covers every output tile
  exactly once at the shapes the card runs: D in {4096, 2048, 1160}, chunk
  widths in {16384, 13568, 3616, 1000};
- the tile and group sizes mirrored here are the ones in the CUDA source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops import fused_xent as jxent  # noqa: E402
from kubeflow_tpu_torch.ops import fused_xent as txent  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

TOL = 1e-6
TM, TN, TK = 128, 256, 64           # output tile (D x chunk columns), K step
GROUP_M = 16                        # row tiles per raster group
H100_SMS = 132
SOURCE = (Path(__file__).resolve().parent.parent / "kubeflow_tpu_torch"
          / "csrc" / "fused_xent.cu")
#: A whole chunk of 768 columns (3 tiles), then a ragged one of 360 (a
#: whole tile and 104 columns).
CHUNK, VOCAB = 768, 1128


def _cdiv(a, b):
    return -(-a // b)


def _close(got, want, what):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    scale = max(1.0, float(np.max(np.abs(want))))
    assert err <= TOL * scale, f"{what}: max abs err {err:.3e}"


def tile_at(tile, n_m, n_n):
    """``tile_at`` of the CUDA source: GROUP_M row tiles at a time, column
    by column."""
    per_group = GROUP_M * n_n
    first = (tile // per_group) * GROUP_M
    rows = min(GROUP_M, n_m - first)
    within = tile % per_group
    return first + within % rows, within // rows


def _grid_walk(n_m, n_n, sms=H100_SMS):
    """(block, m, n) in the order each block of the persistent grid takes
    its tiles: block b takes b, b + grid, ..."""
    n_work = n_m * n_n
    grid = min(n_work, sms)
    return [(b, *tile_at(tile, n_m, n_n))
            for b in range(grid) for tile in range(b, n_work, grid)]


def _box(x, r0, c0, rows, cols, n_rows, n_cols):
    """A rows x cols box of ``x`` at (r0, c0) as TMA loads it through a map
    of extent n_rows x n_cols: zeros outside the extent."""
    out = torch.zeros((rows, cols), dtype=x.dtype)
    r1, c1 = min(r0 + rows, n_rows), min(c0 + cols, n_cols)
    if r1 > r0 and c1 > c0:
        out[:r1 - r0, :c1 - c0] = x[r0:r1, c0:c1]
    return out


def _dw_walk(h, dl, chunk, out_dtype):
    """d_head as ``fused_xent_bwd_bf16`` computes it from the full dl [T, V]
    (the values ``xent_dl_kernel`` writes, chunk by chunk, to the scratch).
    Returns dW [D, V] and the count of writes of each element."""
    t, d = h.shape
    vocab = dl.shape[1]
    dw = torch.full((d, vocab), float("nan"), dtype=out_dtype)
    writes = torch.zeros((d, vocab), dtype=torch.int32)
    scratch = torch.full((t, chunk), 1e6)       # stale until the first chunk
    for c0 in range(0, vocab, chunk):
        vc = min(chunk, vocab - c0)
        scratch[:, :vc] = dl[:, c0:c0 + vc]
        n_m, n_n = _cdiv(d, TM), _cdiv(vc, TN)
        for _, mt, nt in _grid_walk(n_m, n_n):
            m0, n0 = mt * TM, nt * TN
            acc = torch.zeros((TM, TN), dtype=torch.float32)
            for kb in range(_cdiv(t, TK)):
                # A = h^T: one 64 x 64 box of h per consumer (64 rows of D).
                a = torch.cat([_box(h, kb * TK, m0 + 64 * c, TK, 64, t, d)
                               for c in range(TM // 64)], dim=1).T
                # B = dl_c: four 64 x 64 boxes of the scratch, mapped to vc.
                b = torch.cat([_box(scratch, kb * TK, n0 + 64 * q, TK, 64, t,
                                    vc) for q in range(TN // 64)], dim=1)
                acc += a.float() @ b.float()
            rows, cols = min(TM, d - m0), min(TN, vc - n0)
            dw[m0:m0 + rows, c0 + n0:c0 + n0 + cols] = \
                acc[:rows, :cols].to(out_dtype)
            writes[m0:m0 + rows, c0 + n0:c0 + n0 + cols] += 1
    return dw, writes


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, VOCAB)) * d ** -0.5).astype(np.float32)
    tg = rng.integers(0, VOCAB, t).astype(np.int32)
    tg[0] = VOCAB - 1                     # a target in the ragged chunk
    g = rng.standard_normal(t).astype(np.float32)
    return h, w, tg, g


@pytest.mark.parametrize("against", ["plain", "jax"])
@pytest.mark.parametrize("d", [136, 256])
@pytest.mark.parametrize("t", [1, 300])
def test_dw_walk_matches_plain_and_jax(t, d, against):
    h, w, tg, g = _inputs(t, d, seed=t + d)
    th, tw, tt, tgr = (torch.tensor(x) for x in (h, w, tg, g))
    _, lse, _ = txent.xent_fwd_ref(th, tw, tt)
    dl = txent._dlogits_ref(txent._logits_ref(th, tw, None), tt, lse, tgr,
                            None).to(th.dtype)
    got, writes = _dw_walk(th, dl, CHUNK, tw.dtype)
    assert torch.equal(writes, torch.ones_like(writes)), \
        "an element of dW is written other than once"
    if against == "plain":
        _, want = txent.xent_bwd_ref(th, tw, tt, lse, tgr)
    else:
        want = np.array(jax.grad(lambda w_: jnp.sum(
            jxent.fused_cross_entropy(h, w_, tg, interpret=True)[0] * g))(w))
    assert got.shape == tuple(want.shape)
    _close(got, want, f"dW vs {against}")


@pytest.mark.parametrize("vc", [16384, 13568, 3616, 1000])
@pytest.mark.parametrize("d", [4096, 2048, 1160])
def test_grouped_persistent_walk_covers_every_tile_once(d, vc):
    n_m, n_n = _cdiv(d, TM), _cdiv(vc, TN)
    walk = _grid_walk(n_m, n_n)
    tiles = [(m, n) for _, m, n in walk]
    assert len(tiles) == n_m * n_n
    assert sorted(tiles) == [(m, n) for m in range(n_m) for n in range(n_n)]
    blocks = {b for b, _, _ in walk}
    assert len(blocks) == min(n_m * n_n, H100_SMS)


def test_mirrored_sizes_are_the_kernel_sources():
    src = SOURCE.read_text()
    assert re.search(rf"constexpr int TM = {TM}, TN = {TN}, TK = {TK};", src)
    assert re.search(rf"constexpr int GROUP_M = {GROUP_M};", src)
    # The d_head launch: a persistent grid of min(tiles, SMs) over tiles of
    # TM rows of D by TN chunk columns.
    assert "cdiv(D, TM) * cdiv(vc, TN)" in src
    assert "dw_tiles < sms ? dw_tiles : sms" in src
