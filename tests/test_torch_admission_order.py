"""The paged engine's admission order on int8 pages, held against the JAX
package on the CPU (tiny, fp32, ``kv_cache_dtype="int8"``, 16-token pages,
32-token chunks; three prompts that share only their first token, the
longest spanning three chunks):

- the order decides how many prompts find a cached prefix (the shared
  first token, a copy-on-write tail of another prompt's page): a prompt
  admitted after another's prefill reuses that token's K/V, one admitted
  in the same round computes it. JAX's engine and the port's count the
  same hits in each order, different ones across orders, and give the
  same greedy tokens in each;
- what a hit changes: a chunk reads its own tokens' K/V as computed, but
  a cached prefix's from the int8 pool, quantized. The chunk prefill of
  a prompt whose first token's K/V comes from an int8 page gives other
  logits than its prefill from scratch, in JAX and in the port alike
  (each within 1e-5 of the other); from a float page the two agree.

So greedy tokens on int8 pages may depend on the order requests arrive
in, by the reference's own design: a check that compares two engines'
tokens exactly must send them the same requests in the same order, each
after the one before has finished.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models import decoder as jdec  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import paged as jpaged  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models import config as tconfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.serve import engine as E  # noqa: E402
from kubeflow_tpu_torch.serve import paged as tpaged  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

_rng = np.random.default_rng(3)
#: BOS (1) and random tokens: 8, 31 and 71 tokens.
PROMPTS = [[1] + _rng.integers(3, 250, n).tolist() for n in (7, 30, 70)]
SPEC = dict(max_batch_size=4, max_seq_len=128, paged=True, page_size=16,
            chunked_prefill_tokens=32, kv_cache_dtype="int8")
#: Two admission orders whose prefix hits differ.
ORDERS = [(0, 1, 2), (2, 0, 1)]
NEW = 16


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.preset("tiny", dtype="float32")
    jparams = jdec.init_decoder_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jparams, tconfig.preset("tiny", dtype="float32"),
            params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))


def _run(eng, sp, order) -> tuple[dict, int]:
    """All of ``order``'s prompts submitted before the first step: each
    prompt's greedy tokens and the engine's prefix hits."""
    reqs = {i: eng.submit(PROMPTS[i], sp(max_new_tokens=NEW)) for i in order}
    while not all(r.done.is_set() for r in reqs.values()):
        eng.step()
    return ({i: list(r.output_tokens) for i, r in reqs.items()},
            eng.kv_tier_stats()["prefix_hits"])


def test_prefix_hits_follow_the_admission_order_in_both_engines(models):
    jcfg, jparams, cfg, params = models
    hits = []
    for order in ORDERS:
        jtok, jhits = _run(jengine.LLMEngine(
            jcfg, JBatchingSpec(**SPEC, paged_attn_impl="gather"),
            params=jparams), jengine.SamplingParams, order)
        ttok, thits = _run(E.LLMEngine(cfg, BatchingSpec(**SPEC),
                                       params=params, device="cpu"),
                           E.SamplingParams, order)
        assert thits == jhits
        assert ttok == jtok
        hits.append(thits)
    assert hits[0] != hits[1], hits


def _prefills(mod, params, cfg, quant: bool, to, cat):
    """Prompt 1's chunk logits from scratch, and after prompt 0 filled page
    0: its first token's K/V copied to page 3 (the copy-on-write tail a
    prefix hit makes), the chunk from position 1."""
    pg, mpp, chunk = 16, 8, 32
    shape = (cfg.n_layers, 6, pg, cfg.n_kv_heads, cfg.head_dim)
    if quant:
        cache = {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
                 "ks": np.ones(shape[:-1], np.float32),
                 "vs": np.ones(shape[:-1], np.float32)}
    else:
        cache = {"k": np.zeros(shape, np.float32),
                 "v": np.zeros(shape, np.float32)}
    cache = {n: cat(to(a)) for n, a in cache.items()}

    def prefill(cache, prompt, row, start):
        toks = np.zeros((1, chunk), np.int64)
        real = prompt[start:]
        toks[0, :len(real)] = real
        row = np.asarray(row + [-1] * (mpp - len(row)), np.int32)
        ctx = tpaged.context_bucket(start, chunk, pg, mpp)
        out = mod.paged_chunk_prefill(params, cache, to(toks), to(row),
                                      start, len(real), cfg,
                                      context_pages=ctx)
        if isinstance(out, tuple):
            return np.asarray(out[0])[:len(real)], out[1]
        return out[:len(real)].numpy(), cache

    fresh, _ = prefill(cache, PROMPTS[1], [1, 2], 0)
    _, cache = prefill(cache, PROMPTS[0], [0], 0)
    cache = mod.copy_pages(cache, to(np.asarray([0], np.int32)),
                           to(np.asarray([3], np.int32))) or cache
    cached, _ = prefill(cache, PROMPTS[1], [3, 2], 1)
    return fresh[1:], cached


@pytest.mark.parametrize("quant", [True, False], ids=["int8", "float"])
def test_a_cached_prefix_is_read_from_the_pool(models, quant):
    jcfg, jparams, cfg, params = models

    def jto(a):
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)

    def tto(a):
        return torch.from_numpy(np.array(a))

    def tcat(t):       # the port's pools end in the sink page
        return torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)

    jfresh, jcached = _prefills(jpaged, jparams, jcfg, quant, jto,
                                lambda a: a)
    tfresh, tcached = _prefills(tpaged, params, cfg, quant, tto, tcat)
    scale = float(np.abs(jfresh).max())
    for got, want in ((tfresh, jfresh), (tcached, jcached)):
        assert float(np.abs(got - want).max()) <= 1e-5 * scale
    gap = float(np.abs(jcached - jfresh).max())
    if quant:
        assert gap > 1e-4 * scale, gap
        assert float(np.abs(tcached - tfresh).max()) > 1e-4 * scale
    else:
        assert gap <= 1e-5 * scale, gap
