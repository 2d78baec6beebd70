"""The fused cross-entropy kernels' tiling and arithmetic, emulated in plain
PyTorch on the CPU at fp32, against the port's plain versions and the JAX
package's kernels (Pallas in interpret mode).

``csrc/fused_xent.cu`` cannot run here, so what it does beyond the plain
versions is written out once more in plain code and held to them:

- the forward's walk: each block takes one row tile and one range of vocab
  tiles of ``TILE`` columns, as ``_tiles_per_range`` plans them, keeps a
  running max, a sum-exp in base 2 (log2(e) folded in), the picked logit
  and the lowest column among a tile's equal maxima (strict ``>`` across
  tiles), and a combine merges the ranges in index order. nll and lse
  within 1e-6 (relative to the magnitude, at least 1) of ``xent_fwd_ref``
  and of the JAX ``fused_cross_entropy``; ``correct`` exactly equal, with
  argmax ties inside a tile, across a tile boundary inside a range and
  across a range boundary, and targets 0, V - 1 and out of vocab;
- the backward's dl in base 2, ``exp2(s log2(e) - lse log2(e))``, against
  the plain ``_dlogits_ref`` that ``xent_bwd_ref`` uses and the JAX
  kernels' ``_dlogits``, with and without a softcap (1e-6);
- the TMA alignment check, which runs before any launch: a misaligned h,
  W or dl scratch is refused; misaligned targets, lse and g (plain loads)
  are not.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops import fused_xent as jxent  # noqa: E402
from kubeflow_tpu_torch.ops import fused_xent as txent  # noqa: E402

TOL = 1e-6
LOG2E = 1.4426950408889634
#: Forward blocks an H100 runs at once: 132 SMs of one block.
H100_SLOTS = 132


def _close(got, want, what, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    scale = max(1.0, float(np.max(np.abs(want))))
    assert err <= tol * scale, f"{what}: max abs err {err:.3e}"


def _case(t, d, v, seed, ties):
    """fp32 h [t, d], W [d, v] (scale d^-1/2), int32 targets with 0 and
    v - 1. Each (row, (a, b)) of ``ties`` makes columns a and b equal and
    the maxima of that row and the next; the row targets a (the lowest
    index: correct), the next row b (not correct). Row 6 targets v + 5."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * d ** -0.5).astype(np.float32)
    tg = rng.integers(0, v, t).astype(np.int32)
    tg[0], tg[1] = 0, v - 1
    expect = {}
    for row, (a, b) in ties:
        w[:, b] = w[:, a]
        h[row] = h[row + 1] = 8.0 * w[:, a] / np.linalg.norm(w[:, a])
        tg[row], tg[row + 1] = a, b
        expect[row], expect[row + 1] = 1.0, 0.0
    tg[6] = v + 5
    expect[6] = 0.0
    return h, w, tg, expect


def _tiled_forward(h, w, t, softcap, slots):
    """The kernel's forward, tile by tile: per-range partials at
    ``txent.TILE`` columns and ``_tiles_per_range``'s plan, then the
    combine. Returns (nll, lse, correct) and the range boundary."""
    rows, vocab = h.shape[0], w.shape[1]
    s = txent._logits_ref(h, w, softcap)
    tile = txent.TILE
    n_tiles = -(-vocab // tile)
    per = txent._tiles_per_range(rows, vocab, slots)
    idx = torch.arange(rows)
    parts = []
    for first in range(0, n_tiles, per):
        m = torch.full((rows,), -math.inf)
        l = torch.zeros(rows)
        pick = torch.zeros(rows)
        arg = torch.zeros(rows, dtype=torch.long)
        for k in range(first, min(n_tiles, first + per)):
            c0, c1 = k * tile, min(vocab, (k + 1) * tile)
            st = s[:, c0:c1]
            tmax = st.max(dim=1).values
            m_new = torch.maximum(m, tmax)
            mb = m_new * LOG2E
            se = torch.exp2(st * LOG2E - mb[:, None]).sum(dim=1)
            l = torch.where(m == m_new, l,
                            l * torch.exp2(m * LOG2E - mb)) + se
            lowest = c0 + (st == tmax[:, None]).int().argmax(dim=1)
            arg = torch.where(tmax > m, lowest, arg)
            m = m_new
            inside = (t >= c0) & (t < c1)
            col = (t.long() - c0).clamp(0, c1 - c0 - 1)
            pick = pick + torch.where(inside, st[idx, col], 0.0)
        parts.append((m, l, pick, arg))
    big = torch.stack([p[0] for p in parts]).max(dim=0).values
    total = sum(p[1] * torch.exp(p[0] - big) for p in parts)
    picked = sum(p[2] for p in parts)
    best = torch.full((rows,), -math.inf)
    arg = torch.zeros(rows, dtype=torch.long)
    for m, _, _, a in parts:
        arg = torch.where(m > best, a, arg)
        best = torch.maximum(best, m)
    lse = big + torch.log(total)
    return lse - picked, lse, (arg == t.long()).float(), per * tile


#: (V, slots, ties): at 132 slots T = 8 and V = 1000 give 4 ranges of one
#: tile (a range boundary at 256); at 3 slots V = 3072 gives 3 ranges of 4
#: tiles, so one tie straddles a tile boundary inside a range and one a
#: range boundary (1024).
PLANS = {
    "h100_slots": (1000, H100_SLOTS, ((2, (3, 40)), (4, (250, 260)))),
    "ranges_of_4": (3072, 3, ((2, (250, 260)), (4, (1020, 1030)))),
}


@pytest.mark.parametrize("cap", [None, 5.0])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_tiled_forward_matches_plain_and_jax(plan, cap):
    v, slots, ties = PLANS[plan]
    h, w, tg, expect = _case(8, 16, v, seed=11, ties=ties)
    th, tw, tt = (torch.tensor(x) for x in (h, w, tg))
    nll, lse, correct, boundary = _tiled_forward(th, tw, tt, cap, slots)
    # The second tie pair straddles the first range boundary.
    assert ties[1][1][0] < boundary <= ties[1][1][1]
    rn, rl, rc = txent.xent_fwd_ref(th, tw, tt, cap)
    _close(nll, rn, "nll vs plain")
    _close(lse, rl, "lse vs plain")
    assert torch.equal(correct, rc)
    for row, want in expect.items():
        assert float(correct[row]) == want, row
    assert float(nll[6]) == pytest.approx(float(lse[6]), abs=TOL)
    jn, jc = jxent.fused_cross_entropy(h, w, tg, logits_softcap=cap,
                                       interpret=True)
    _close(nll, np.array(jn), "nll vs jax")
    np.testing.assert_array_equal(correct.numpy(), np.array(jc))


def _dl_base2(s, t, lse, g, softcap):
    """The dl recompute's arithmetic: p in base 2 from lse in log2 units,
    minus the one-hot of the target's column, times g, times 1 - (s/c)^2
    with a softcap."""
    p = torch.exp2(s * LOG2E - (lse * LOG2E)[:, None])
    cols = torch.arange(s.shape[1])
    onehot = (cols[None, :] == t.long()[:, None]).float()
    dl = (p - onehot) * g[:, None]
    if softcap is not None:
        dl = dl * (1.0 - (s / softcap) ** 2)
    return dl


@pytest.mark.parametrize("cap", [None, 5.0])
def test_base2_dlogits_match_plain_and_jax(cap):
    h, w, tg, _ = _case(8, 16, 1000, seed=12, ties=())
    rng = np.random.default_rng(13)
    g = rng.standard_normal(8).astype(np.float32)
    th, tw, tt, tgr = (torch.tensor(x) for x in (h, w, tg, g))
    s = txent._logits_ref(th, tw, cap)
    lse = torch.logsumexp(s, dim=-1)
    got = _dl_base2(s, tt, lse, tgr, cap)
    want = txent._dlogits_ref(s, tt, lse, tgr, cap)
    _close(got, want, "dl vs plain")
    assert torch.count_nonzero(got[6] < 0) == 0     # out of vocab: no -1
    cols = jnp.arange(1000, dtype=jnp.int32)[None, :]
    jdl = jxent._dlogits(h, w, tg[:, None], lse.numpy()[:, None],
                         g[:, None], cols, cap)
    _close(got, np.array(jdl), "dl vs jax")


def _aligned_and_shifted(n):
    base = torch.zeros(n + 8, dtype=torch.bfloat16)
    return base[:n], base[1:1 + n]                  # 2 bytes in


@pytest.mark.parametrize("name,bad", [("xent_fwd", "h"), ("xent_fwd", "w"),
                                      ("xent_bwd", "h"), ("xent_bwd", "w"),
                                      ("xent_bwd", "scratch")])
def test_misaligned_tma_input_is_refused(name, bad):
    aligned, shifted = _aligned_and_shifted(64)
    tensors = {"h": aligned, "w": aligned, "scratch": aligned}
    with pytest.raises(ValueError, match="16-byte"):
        txent._check_tma(name, {**tensors, bad: shifted})


def test_misaligned_targets_lse_and_g_are_accepted():
    aligned, _ = _aligned_and_shifted(64)
    rows = torch.zeros(9)[1:]                       # 4 bytes in
    tgt = torch.zeros(9, dtype=torch.int32)[1:]
    assert rows.data_ptr() % 16 and tgt.data_ptr() % 16
    for name in ("xent_fwd", "xent_bwd"):
        txent._check_tma(name, {"h": aligned, "w": aligned,
                                "scratch": aligned, "t": tgt, "lse": rows,
                                "g": rows})
