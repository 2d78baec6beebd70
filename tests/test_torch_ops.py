"""The port's kernel modules on the CPU: each plain version against the JAX
package's op on the same numpy inputs (Pallas kernels run in interpret mode,
as tests/test_fused_kernels.py runs them), plus the wrapper contract — a CPU
tensor takes the plain version and counts no launch, any other non-CUDA
tensor raises.

Tolerances (float32 throughout, as |got - want| <= tol * (1 + |want|)
elementwise: a few ulps at the value's own magnitude): norms and gated
activations 1e-6 (the same op sequence, fp32 statistics; the mean's
summation order differs); attention 1e-5 (blockwise online softmax on the
JAX side vs one pass here)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.ops import attention as jattn  # noqa: E402
from kubeflow_tpu.ops import flash_attention as jflash  # noqa: E402
from kubeflow_tpu.ops import fused_norm as jnorm  # noqa: E402
from kubeflow_tpu.models import layers as jlayers  # noqa: E402
from kubeflow_tpu_torch.models import layers as tlayers  # noqa: E402
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.ops import attention as tattn  # noqa: E402
from kubeflow_tpu_torch.ops import fused_norm as tnorm  # noqa: E402
from kubeflow_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402

NORM_TOL = 1e-6
ATTN_TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _maxdiff(a, b):
    """Largest |a - b| / (1 + |b|) over the elements."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


# -- fused norms and gated activations -----------------------------------------

@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_jax(plus_one):
    r = _rng(1)
    x = r.standard_normal((6, 24, 64)).astype(np.float32)
    w = r.standard_normal(64).astype(np.float32)
    want = jnorm.rmsnorm_fused(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                               plus_one=plus_one, interpret=True)
    got = tnorm.rmsnorm_fused(_t(x), _t(w), eps=1e-5, plus_one=plus_one)
    assert got.shape == x.shape
    assert _maxdiff(got, want) <= NORM_TOL


@pytest.mark.parametrize("plus_one", [False, True])
def test_add_rmsnorm_matches_jax(plus_one):
    r = _rng(2)
    x = r.standard_normal((40, 128)).astype(np.float32)
    res = r.standard_normal((40, 128)).astype(np.float32)
    w = r.standard_normal(128).astype(np.float32)
    wy, wo = jnorm.add_rmsnorm_fused(jnp.asarray(x), jnp.asarray(res),
                                     jnp.asarray(w), eps=1e-6,
                                     plus_one=plus_one, interpret=True)
    gy, go = tnorm.add_rmsnorm_fused(_t(x), _t(res), _t(w), eps=1e-6,
                                     plus_one=plus_one)
    assert _maxdiff(gy, wy) <= NORM_TOL
    assert _maxdiff(go, wo) <= NORM_TOL


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_matches_jax(act):
    r = _rng(3)
    g = (3 * r.standard_normal((16, 256))).astype(np.float32)
    u = r.standard_normal((16, 256)).astype(np.float32)
    want = jnorm.swiglu_fused(jnp.asarray(g), jnp.asarray(u), act=act,
                              interpret=True)
    got = tnorm.swiglu_fused(_t(g), _t(u), act=act)
    assert _maxdiff(got, want) <= NORM_TOL


def test_layers_rmsnorm_plus_one_and_mlp_act_match_jax():
    """The layer-level plain paths (layers.rmsnorm / the unfused act in
    mlp_block) against the JAX layers on a gemma-style config."""
    r = _rng(4)
    jcfg = jlayers.DecoderConfig(hidden=32, norm_plus_one=True,
                                 hidden_act="gelu", mlp_dim=48,
                                 dtype="float32", fused_kernels="off")
    tcfg = preset("tiny", hidden=32, norm_plus_one=True, hidden_act="gelu",
                  mlp_dim=48, dtype="float32", fused_kernels="off")
    x = r.standard_normal((2, 5, 32)).astype(np.float32)
    w = r.standard_normal(32).astype(np.float32)
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), jcfg)
    assert _maxdiff(tlayers.rmsnorm(_t(x), _t(w), tcfg), want) <= NORM_TOL
    p = {k: r.standard_normal(s).astype(np.float32) * 0.2 for k, s in
         (("gate", (32, 48)), ("up", (32, 48)), ("down", (48, 32)))}
    want = jlayers.mlp_block({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jcfg)
    got = tlayers.mlp_block({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    assert _maxdiff(got, want) <= ATTN_TOL


def test_rope_matches_jax():
    r = _rng(5)
    x = r.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(9) + 3, np.arange(9) * 7]).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    got = tlayers.rope(_t(x), _t(pos.astype(np.int64)), 500000.0)
    assert _maxdiff(got, want) <= ATTN_TOL


# -- attention -----------------------------------------------------------------

FLASH_CASES = {
    # name: (B, H, KH, Sq, Skv, D, causal, q_offset, softcap)
    "gqa_causal": (2, 4, 2, 32, 32, 16, True, 0, None),
    "q_offset": (1, 4, 1, 16, 48, 16, True, 32, None),
    "softcap": (1, 4, 2, 32, 32, 16, True, 0, 5.0),
    "full": (1, 2, 2, 16, 32, 8, False, 0, None),
    # The kernels' tile edges (128-row q and kv tiles), head_dim 64 and 128.
    "len127_d64": (1, 4, 2, 127, 127, 64, True, 0, None),
    "len129_d128": (1, 4, 2, 129, 129, 128, True, 0, None),
    "len129_d64_softcap": (1, 4, 4, 129, 129, 64, True, 0, 5.0),
    "diag_off128_d128": (1, 4, 2, 200, 328, 128, True, 128, None),
    "neg_offset_d128": (1, 4, 2, 127, 127, 128, True, -5, None),
}
# JAX (block_q, block_kv) where its _fit_block refuses the length (no
# 128-aligned divisor): blocks that divide it; (None, None) otherwise.
FLASH_BLOCKS = {
    "len129_d128": (129, 129),
    "len129_d64_softcap": (43, 43),
    "diag_off128_d128": (100, 82),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(case):
    b, h, kh, sq, skv, d, causal, off, cap = FLASH_CASES[case]
    bq, bkv = FLASH_BLOCKS.get(case, (None, None))
    r = _rng(6)
    q = r.standard_normal((b, sq, h, d)).astype(np.float32)
    k = r.standard_normal((b, skv, kh, d)).astype(np.float32)
    v = r.standard_normal((b, skv, kh, d)).astype(np.float32)
    swap = (0, 2, 1, 3)
    wo, wl = jflash._flash_fwd(
        jnp.asarray(q.transpose(swap)), jnp.asarray(k.transpose(swap)),
        jnp.asarray(v.transpose(swap)), causal=causal, sm_scale=d ** -0.5,
        softcap=cap, q_offset=off, block_q=bq, block_kv=bkv,
        interpret=True)
    o, lse = flash_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=off,
                             logits_softcap=cap)
    assert o.shape == (b, sq, h, d) and lse.shape == (b, h, sq)
    assert _maxdiff(o, np.asarray(wo).transpose(swap)) <= ATTN_TOL
    assert _maxdiff(lse, wl) <= ATTN_TOL
    # The JAX public function returns o only, in the [B,S,H,D] layout.
    pub = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, q_offset=off,
                                 logits_softcap=cap, block_q=bq,
                                 block_kv=bkv, interpret=True)
    assert _maxdiff(o, pub) <= ATTN_TOL


@pytest.mark.parametrize("q_offset", [-5, -70, -200])
def test_flash_rows_that_see_no_key_average_every_value(q_offset):
    """A row with no visible key (q_offset + row < 0) has every logit at
    the finite NEG_INF: it averages V over all Skv keys, with lse NEG_INF,
    as the JAX package's plain attention does; at -200 the first 128-row
    tile of the CUDA kernel sees nothing at all."""
    r = _rng(8)
    sq = skv = 300
    q = r.standard_normal((1, sq, 4, 16)).astype(np.float32)
    k = r.standard_normal((1, skv, 2, 16)).astype(np.float32)
    v = r.standard_normal((1, skv, 2, 16)).astype(np.float32)
    o, lse = flash_attention(_t(q), _t(k), _t(v), causal=True,
                             q_offset=q_offset)
    want = jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), q_offset=q_offset)
    assert _maxdiff(o, want) <= ATTN_TOL
    blind = -q_offset
    mean_v = np.repeat(v.mean(axis=1, keepdims=True), 2, axis=2)
    assert _maxdiff(o[:, :blind], np.broadcast_to(
        mean_v, (1, blind, 4, 16))) <= ATTN_TOL
    assert torch.all(lse[:, :, :blind] == tattn.NEG_INF)
    assert torch.all(lse[:, :, blind:] > tattn.NEG_INF / 2)


@pytest.mark.parametrize("q_offset,softcap,masked", [
    (0, None, False), (5, None, False), (3, 20.0, False), (0, None, True)])
def test_multi_head_attention_matches_jax(q_offset, softcap, masked):
    r = _rng(7)
    q = r.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, 12, 2, 16)).astype(np.float32)
    mask = (r.random((2, 1, 6, 12)) > 0.3) if masked else None
    want = jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_offset,
        logits_softcap=softcap,
        mask=None if mask is None else jnp.asarray(mask))
    got = tattn.multi_head_attention(
        _t(q), _t(k), _t(v), q_offset=q_offset, logits_softcap=softcap,
        mask=None if mask is None else _t(mask))
    assert _maxdiff(got, want) <= ATTN_TOL
    # impl="pallas" (the flash path) agrees with the plain path unmasked.
    if not masked:
        flash = tattn.multi_head_attention(
            _t(q), _t(k), _t(v), q_offset=q_offset, logits_softcap=softcap,
            impl="pallas")
        assert _maxdiff(flash, want) <= ATTN_TOL


def test_neg_inf_and_repeat_kv_match_jax():
    assert tattn.NEG_INF == jattn.NEG_INF
    k = _rng(8).standard_normal((1, 3, 2, 4)).astype(np.float32)
    assert _maxdiff(tattn._repeat_kv(_t(k), 3),
                    jattn._repeat_kv(jnp.asarray(k), 3)) == 0.0
    assert np.array_equal(tattn.causal_mask(4, 6, q_offset=2).numpy(),
                          np.asarray(jattn.causal_mask(4, 6, q_offset=2)))


# -- the wrapper contract ----------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = (tnorm.rmsnorm_fused.launches, tnorm.add_rmsnorm_fused.launches,
              tnorm.swiglu_fused.launches, flash_attention.launches)
    x = torch.randn(4, 32)
    w = torch.randn(32)
    assert torch.equal(tnorm.rmsnorm_fused(x, w, eps=1e-5),
                       tnorm.rmsnorm_ref(x, w, eps=1e-5))
    y, h = tnorm.add_rmsnorm_fused(x, x, w, eps=1e-5)
    assert torch.equal(h, tnorm.rmsnorm_ref(x + x, w, eps=1e-5))
    assert torch.equal(tnorm.swiglu_fused(x, x), tnorm.swiglu_ref(x, x))
    q = torch.randn(1, 8, 2, 8)
    flash_attention(q, q, q)
    after = (tnorm.rmsnorm_fused.launches, tnorm.add_rmsnorm_fused.launches,
             tnorm.swiglu_fused.launches, flash_attention.launches)
    assert after == before


def test_non_cpu_non_cuda_tensors_raise():
    """A wrapper launches its kernel or raises — it never drops to the
    plain version for a tensor that is not on the CPU."""
    x = torch.empty(4, 32, device="meta")
    w = torch.empty(32, device="meta")
    with pytest.raises(ValueError):
        tnorm.rmsnorm_fused(x, w, eps=1e-5)
    with pytest.raises(ValueError):
        tnorm.add_rmsnorm_fused(x, x, w, eps=1e-5)
    with pytest.raises(ValueError):
        tnorm.swiglu_fused(x, x)
    q = torch.empty(1, 8, 2, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                        torch.zeros(1, 4, 2, 8), q_offset=torch.tensor(1))


def test_fused_kernels_resolution():
    x = torch.zeros(2, 4)
    assert not tlayers.fused_kernels_on(preset("tiny"), x)
    assert tlayers.fused_kernels_on(preset("tiny", fused_kernels="on"), x)
    assert not tlayers.fused_kernels_on(preset("tiny", fused_kernels="off"), x)
    with pytest.raises(ValueError):
        tlayers.fused_kernels_on(preset("tiny", fused_kernels="maybe"), x)
