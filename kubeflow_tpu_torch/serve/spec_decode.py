"""Speculative decoding — draft + batched verify over the slot cache or the
page pool: the port of ``kubeflow_tpu/serve/spec_decode.py``.

A decode step reads every weight for one token per slot, so scoring the
k + 1 positions ``[last_token, draft_1 .. draft_k]`` of every slot in one
verify dispatch costs about one step, and greedy verification emits the
longest draft prefix that matches the target's own argmax chain plus the
target's token at the first mismatch: 1 to k + 1 tokens per slot and
round, identical to plain greedy decode. The drafts come from:

- ``ngram_propose``: the context's last n-gram looked up in its own
  earlier tokens (no model);
- ``draft_propose``: a small decoder stepping ahead over its own dense
  slot cache through the engine's ``_decode_step``, as a Python loop whose
  argmax stays on the device (one host copy per round, after the loop).

The verify writes the K/V of all T positions before acceptance is known;
the engine rolls a rejected tail back (the paged engine truncates the
slot's page list; the dense cache is overwritten before it is read).

What eager PyTorch changes against the JAX functions:

- **Writes the JAX package drops** (dead rows, positions past the cache,
  unmapped pages) must not change the cache, and torch has no dropping
  scatter. The dense verify rewrites the value already at the row's
  position 0 for such a column (a slot mid chunked prefill has real KV
  there), as the engine's decode does; the paged verify aims them at the
  pool's sink page (serve/paged.py).
- **Paged verify attention** is "gather" (the JAX path: the slots' pages
  materialised, then ``_spec_attention``) or "pallas": the one-query
  paged-decode kernel over B·T virtual rows
  (``ops/paged_attention.paged_verify_attention``), exact because query t
  of row b attends to positions ``<= lengths[b] + t`` — a decode row's
  rule.
- Caches and pools are written in place (the JAX functions return new
  arrays); ids come back as int64.
"""

from __future__ import annotations

from typing import Sequence

import torch

from kubeflow_tpu_torch.models import layers as L
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.models.decoder import Params, ffn, layer_view, lm_head
from kubeflow_tpu_torch.ops.paged_attention import paged_verify_attention
from kubeflow_tpu_torch.ops.quantization import dequantize_kv, quantize_kv
from kubeflow_tpu_torch.serve.paged import paged_gather


# -- drafting ------------------------------------------------------------------

def ngram_propose(ctx: Sequence[int], k: int, ngram_max: int,
                  ngram_min: int) -> list[int]:
    """Prompt/self-lookup drafting: find the most recent earlier occurrence
    of the context's last n-gram (longest n first) and propose the up-to-k
    tokens that followed it; [] when nothing matches (the engine then
    decodes that slot normally)."""
    ln = len(ctx)
    for n in range(min(ngram_max, ln - 1), ngram_min - 1, -1):
        pat = tuple(ctx[ln - n:])
        # Rightmost earlier occurrence: recent history predicts the
        # immediate future better than the distant past.
        for i in range(ln - n - 1, -1, -1):
            if tuple(ctx[i:i + n]) == pat:
                out = list(ctx[i + n:i + n + k])
                if out:
                    return out
                break       # match flush against the suffix: nothing follows
    return []


def draft_propose(params: Params, cache: dict, deltas: torch.Tensor,
                  delta_lens: torch.Tensor, draft_pos: torch.Tensor,
                  live: torch.Tensor, cfg: DecoderConfig,
                  num_steps: int) -> torch.Tensor:
    """``num_steps`` single-token decode steps of the draft model over its
    dense slot cache (written in place), with no host synchronisation.

    Per slot b: step t < delta_lens[b] feeds deltas[b, t] (true tokens the
    draft has not consumed yet); later steps feed the draft's own greedy
    token from the step before. Step t writes at ``draft_pos[b] + t``; rows
    that reach the cache's end stop writing. Returns out [B, num_steps]
    int64: every step's argmax (slot b's k drafts sit at columns
    delta_lens[b] - 1 ..)."""
    from kubeflow_tpu_torch.serve.engine import _decode_step

    b, dmax = deltas.shape
    max_len = cache["k"].shape[2]
    prev = torch.zeros((b,), dtype=torch.int64, device=deltas.device)
    out = torch.empty((b, num_steps), dtype=torch.int64, device=deltas.device)
    for t in range(num_steps):
        fed = torch.where(t < delta_lens, deltas[:, min(t, dmax - 1)], prev)
        lengths = draft_pos + t
        logits = _decode_step(params, cache, fed, lengths,
                              live & (lengths < max_len), cfg)
        prev = torch.argmax(logits, dim=-1)
        out[:, t] = prev
    return out


# -- batched verify (dense slot cache) -----------------------------------------

def _spec_attention(q, ck, cv, lengths, cfg: DecoderConfig):
    """T-query attention over slot caches (the engine's
    ``_decode_attention`` with a verify-length axis). q [B,T,H,Dh]; ck/cv
    [B,Smax,KV,Dh]; query t sits at position lengths[b] + t and attends to
    kpos <= that."""
    b, t = q.shape[0], q.shape[1]
    smax = ck.shape[1]
    groups = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, t, cfg.n_kv_heads, groups, cfg.head_dim)
    scores = torch.einsum("btkgd,bskd->btkgs", qg.float(), ck.float())
    scores = scores * cfg.head_dim ** -0.5
    kpos = torch.arange(smax, device=ck.device)
    qpos = lengths[:, None] + torch.arange(t, device=ck.device)[None, :]
    mask = kpos[None, None, :] <= qpos[:, :, None]              # [B,T,Smax]
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(ck.dtype)
    out = torch.einsum("btkgs,bskd->btkgd", probs, cv)
    return out.reshape(b, t, cfg.n_heads, cfg.head_dim)


def _dense_write(cache: torch.Tensor, vals: torch.Tensor,
                 positions: torch.Tensor, ok: torch.Tensor) -> None:
    """cache [B,Smax,...] <- vals [B,T,...] at positions [B,T] where ``ok``;
    every other column rewrites the value already at its row's position 0
    (the cache does not change there)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)[:, None]
    widx = torch.where(ok, positions, torch.zeros_like(positions))
    keep = ok.reshape(ok.shape + (1,) * (vals.dim() - 2))
    cache[bidx, widx] = torch.where(keep, vals, cache[bidx, widx])


def _qkv(bp, x, positions, cfg: DecoderConfig):
    dt = cfg.activation_dtype
    h = L.rmsnorm(x, bp["ln1"], cfg)
    q = L.project(h, bp["attn"]["wq"], dt)
    k = L.project(h, bp["attn"]["wk"], dt)
    v = L.project(h, bp["attn"]["wv"], dt)
    return (L.rope(q, positions, cfg.rope_theta),
            L.rope(k, positions, cfg.rope_theta), v)


def _finish_block(bp, x, attn, cfg: DecoderConfig):
    x = x + L.out_project(attn, bp["attn"]["wo"], cfg.activation_dtype)
    h = L.rmsnorm(x, bp["ln2"], cfg)
    return x + ffn(bp, h, cfg)


def _spec_block(bp, x, positions, lengths, live, cache_k, cache_v,
                cfg: DecoderConfig):
    """One transformer block of a [B,T] verify step against one layer's slot
    caches. Writes the K/V of all T tokens at positions[b, t]; dead rows and
    positions past the cache leave it unchanged."""
    q, k, v = _qkv(bp, x, positions, cfg)
    ok = live[:, None] & (positions < cache_k.shape[1])
    _dense_write(cache_k, k, positions, ok)
    _dense_write(cache_v, v, positions, ok)
    attn = _spec_attention(q, cache_k, cache_v, lengths, cfg)
    return _finish_block(bp, x, attn, cfg)


def _embed(params: Params, tokens: torch.Tensor, cfg: DecoderConfig):
    x = params["embed"][tokens].to(cfg.activation_dtype)        # [B,T,D]
    if cfg.embed_scale:
        x = x * L.embed_scale_value(cfg)
    return x


def _verify_logits(params: Params, cache: dict, tokens: torch.Tensor,
                   lengths: torch.Tensor, live: torch.Tensor,
                   cfg: DecoderConfig) -> torch.Tensor:
    """``verify_step`` before its argmax: [B,T,V] fp32 logits."""
    t = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    positions = lengths[:, None] + torch.arange(t, device=tokens.device)
    for i in range(cfg.n_layers):
        x = _spec_block(layer_view(params["layers"], i), x, positions,
                        lengths, live, cache["k"][i], cache["v"][i], cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg)
    return lm_head(params, x, cfg)


def verify_step(params: Params, cache: dict, tokens: torch.Tensor,
                lengths: torch.Tensor, live: torch.Tensor,
                cfg: DecoderConfig) -> torch.Tensor:
    """ONE dispatch scoring T = k + 1 positions per slot over the dense slot
    cache (written in place). tokens [B,T] = [last_token, draft_1 ..
    draft_k] (pad columns are scored too; the host ignores them); lengths
    [B] = the write position of tokens[:, 0], as in the engine's decode.

    Returns [B,T] int64 greedy ids: row b column t is the target's argmax
    after consuming tokens[b, :t+1] — the check of draft t + 1, and the
    correction token where the match breaks."""
    return torch.argmax(_verify_logits(params, cache, tokens, lengths, live,
                                       cfg), dim=-1)


# -- batched verify (paged pool) -----------------------------------------------

def _paged_spec_block(bp, x, positions, lengths, live, pool_k, pool_v,
                      table, cfg: DecoderConfig, attn_impl: str = "gather",
                      pool_ks=None, pool_vs=None):
    """Verify block against one layer's page pool (written in place).
    Position -> (page, offset) per token; dead rows, unmapped pages and
    positions past the table's reach write the sink page. An int8 pool
    quantizes each written token per token and per head, as decode does.
    ``attn_impl``: "gather" materialises the slots' pages (dequantized) for
    ``_spec_attention``; "pallas" runs the paged-decode kernel over B·T
    virtual rows."""
    dt = cfg.activation_dtype
    q, k, v = _qkv(bp, x, positions, cfg)
    pg, mpp, sink = pool_k.shape[1], table.shape[1], pool_k.shape[0] - 1
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    page_id = table[bidx, (positions // pg).clamp(0, mpp - 1)].long()
    ok = live[:, None] & (page_id >= 0) & (positions < mpp * pg)
    pidx = torch.where(ok, page_id, sink)
    off = positions % pg
    quant = pool_ks is not None
    if quant:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        pool_k[pidx, off] = kq
        pool_v[pidx, off] = vq
        pool_ks[pidx, off] = ks
        pool_vs[pidx, off] = vs
    else:
        pool_k[pidx, off] = k
        pool_v[pidx, off] = v
    if attn_impl == "pallas":
        attn = paged_verify_attention(q, pool_k, pool_v, table, lengths,
                                      pool_ks=pool_ks, pool_vs=pool_vs)
    elif quant:
        ck = dequantize_kv(paged_gather(pool_k, table),
                           paged_gather(pool_ks, table), dt)
        cv = dequantize_kv(paged_gather(pool_v, table),
                           paged_gather(pool_vs, table), dt)
        attn = _spec_attention(q, ck, cv, lengths, cfg)
    else:
        attn = _spec_attention(q, paged_gather(pool_k, table),
                               paged_gather(pool_v, table), lengths, cfg)
    return _finish_block(bp, x, attn, cfg)


def _paged_verify_logits(params: Params, cache: dict, tokens: torch.Tensor,
                         lengths: torch.Tensor, live: torch.Tensor,
                         cfg: DecoderConfig,
                         attn_impl: str = "gather") -> torch.Tensor:
    """``paged_verify_step`` before its argmax: [B,T,V] fp32 logits."""
    quant = "ks" in cache
    t = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    positions = lengths[:, None] + torch.arange(t, device=tokens.device)
    for i in range(cfg.n_layers):
        x = _paged_spec_block(
            layer_view(params["layers"], i), x, positions, lengths, live,
            cache["k"][i], cache["v"][i], cache["table"], cfg,
            attn_impl=attn_impl,
            pool_ks=cache["ks"][i] if quant else None,
            pool_vs=cache["vs"][i] if quant else None)
    x = L.rmsnorm(x, params["final_norm"], cfg)
    return lm_head(params, x, cfg)


def paged_verify_step(params: Params, cache: dict, tokens: torch.Tensor,
                      lengths: torch.Tensor, live: torch.Tensor,
                      cfg: DecoderConfig,
                      attn_impl: str = "gather") -> torch.Tensor:
    """``verify_step`` over the page pool (``cache`` carries "table"; the
    host pre-allocates pages covering all T write positions, as for a
    multi-step decode). Returns [B,T] int64 greedy ids."""
    return torch.argmax(_paged_verify_logits(params, cache, tokens, lengths,
                                             live, cfg, attn_impl=attn_impl),
                        dim=-1)
