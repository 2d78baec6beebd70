#!/usr/bin/env python3
"""Host enqueue and wall time of the PyTorch port's decode dispatch and
bucketed prefill on one CUDA card, for comparing two trees of the port on
one machine.

    python3 scripts/torch_decode_enqueue.py [--tree DIR] [--layers N]
                                            [--reps N] [--label NAME]

Imports ``kubeflow_tpu_torch`` from ``--tree`` (default: this checkout).
Builds Llama-3-8B at full width with ``--layers`` layers of random bf16
weights (seed 0) on an 8-slot contiguous cache, then times ``--reps``
8-step greedy decode dispatches at 8 live slots, cache position 1024, on
the contiguous cache and on a page pool of 128-token pages, and one
2048-token prefill of one slot through the flash kernel, as the profile
phase of ``chip_smoke.py`` does: host enqueue (until the call returns) and
wall (until a synchronize), per step, under ``no_grad``. Then the host
time of one call of each fused wrapper the decode step calls
(``rmsnorm_fused``, ``add_rmsnorm_fused``, ``swiglu_fused``) at the decode
shapes, [8, 4096] and [8, 14336] bf16, and of ``flash_attention`` at the
prefill's [1, 2048, 32, 128] bf16: ``--reps`` batches of 200 calls,
each batch timed to its return, under ``no_grad`` as serving calls them
and, where the tree's wrappers have a backward, once more with the
weight requiring a gradient (the autograd Function path that training
takes). Prints one JSON line with the median, minimum and maximum of
each. Run two trees
alternately (A, B, B, A), each in its own process, to compare them: host
times on a shared machine drift between runs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def summary(xs: list[float]) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def wrapper_us(fn, reps: int) -> list[float]:
    """Host microseconds per call of ``fn``, over ``reps`` batches of 200
    calls after 20 warm ones."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e6 / 200)
        torch.cuda.synchronize()
    return per_call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("torch_decode_enqueue: no CUDA device", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.ops import _build, fused_norm
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.serve import engine as E
    from kubeflow_tpu_torch.serve.engine import LLMEngine
    from kubeflow_tpu_torch.serve.paged import paged_decode_multi

    _build.build_all()
    cfg = preset("llama3-8b", n_layers=args.layers)
    engine = LLMEngine(cfg, BatchingSpec(
        max_batch_size=8, max_seq_len=2048, prefill_attn_impl="pallas",
        chunked_prefill_tokens=1024, weights_dtype="bfloat16"),
        seed=0, device="cuda")
    dev, b, steps = engine.device, engine.num_slots, 8
    st = [torch.full((b,), 5, device=dev),                   # tokens
          torch.full((b,), 1024, device=dev),                # lengths
          torch.ones((b,), dtype=torch.bool, device=dev),    # live
          torch.zeros((b,), device=dev),                     # temps
          torch.zeros((b,), dtype=torch.long, device=dev),   # top_k
          torch.ones((b,), device=dev),                      # top_p
          torch.full((b,), -1, device=dev),                  # stops
          torch.full((b,), 1 << 20, device=dev)]             # budgets
    pg, mpp, per_slot = 128, 16, 9
    shape = (cfg.n_layers, b * per_slot + 1, pg, cfg.n_kv_heads, cfg.head_dim)
    kv = engine.cache["k"].dtype
    pool = {"k": torch.zeros(shape, dtype=kv, device=dev),
            "v": torch.zeros(shape, dtype=kv, device=dev),
            "table": torch.full((b, mpp), -1, dtype=torch.int32, device=dev)}
    pool["table"][:, :per_slot] = torch.arange(
        b * per_slot, dtype=torch.int32, device=dev).reshape(b, per_slot)
    toks = torch.randint(3, 259, (1, 2048), device=dev)
    slot, plen = (torch.zeros((1,), dtype=torch.long, device=dev),
                  torch.full((1,), 2048, device=dev))
    calls = {
        "decode": (lambda: E._decode_multi(
            engine.params, engine.cache, *st, engine._gen, cfg, steps,
            sample_mode="greedy"), steps),
        "paged_decode": (lambda: paged_decode_multi(
            engine.params, pool, *st, engine._gen, cfg, steps,
            sample_mode="greedy", attn_impl="pallas"), steps),
        "prefill": (lambda: E._prefill_step(
            engine.params, engine.cache, toks, slot, plen, cfg, "pallas"),
            1),
    }
    out = {"label": args.label, "tree": args.tree, "layers": args.layers,
           "reps": args.reps, "card": torch.cuda.get_device_name(0)}
    with torch.no_grad():
        for name, (fn, per) in calls.items():
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            enq, wall = [], []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                fn()
                enq.append((time.perf_counter() - t0) * 1e3 / per)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3 / per)
            for key, xs in (("enqueue_ms", enq), ("wall_ms", wall)):
                out[f"{name}_{key}"] = summary(xs)
    x = torch.randn((b, cfg.hidden), device=dev).to(torch.bfloat16)
    g = torch.randn((b, cfg.mlp_dim), device=dev).to(torch.bfloat16)
    q = torch.randn((1, 2048, cfg.n_heads, cfg.head_dim), device=dev).to(
        torch.bfloat16)
    k = torch.randn((1, 2048, cfg.n_kv_heads, cfg.head_dim), device=dev).to(
        torch.bfloat16)
    for mode in ("no_grad", "graph"):
        w = torch.ones((cfg.hidden,), dtype=torch.bfloat16, device=dev,
                       requires_grad=mode == "graph")
        u = g.clone().requires_grad_(mode == "graph")
        qg = q.clone().requires_grad_(mode == "graph")
        wrappers = {
            "rmsnorm_fused": lambda: fused_norm.rmsnorm_fused(x, w, eps=1e-5),
            "add_rmsnorm_fused": lambda: fused_norm.add_rmsnorm_fused(
                x, x, w, eps=1e-5),
            "swiglu_fused": lambda: fused_norm.swiglu_fused(g, u),
            "flash_attention": lambda: flash_attention(qg, k, k),
        }
        with torch.set_grad_enabled(mode == "graph"):
            for name, fn in wrappers.items():
                try:
                    fn()
                except RuntimeError:      # a tree without the backward
                    out[f"{name}_{mode}_host_us"] = None
                    continue
                out[f"{name}_{mode}_host_us"] = summary(
                    wrapper_us(fn, args.reps))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
