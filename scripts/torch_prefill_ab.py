#!/usr/bin/env python3
"""Host enqueue of the PyTorch port's bucketed 2048-token prefill on one
CUDA card, for this checkout against another, in ONE process: the two
trees' calls interleave rep by rep (B, A, A, B, ...), so both run in the
same process state, where runs in separate processes drift by more than
the difference sought.

    python3 scripts/torch_prefill_ab.py OTHER

``OTHER`` is a checkout of the port that registers no dispatcher ops of
its own (the parent of the tree that made the flash forward an op).
Imports ``kubeflow_tpu_torch`` from ``OTHER`` first, keeps its modules,
then imports it again from the checkout that holds the script. Builds
Llama-3-8B at full width, all 32 layers, random bf16 weights (seed 0), on
an 8-slot engine of this checkout; each tree's ``_prefill_step`` runs on
those same weights and cache, one 2048-token prompt through the flash
kernel under ``no_grad``, as the engine's prefill does. Per rep: host
enqueue (until the call returns) and wall (until a synchronize). Then the
host time of one ``flash_attention`` call of each tree at the prefill's
[1, 2048, 32, 128] bf16, batches of 200 calls interleaved the same way,
under ``no_grad`` and with q requiring a gradient (the path a training
step's forward and replay take). Prints one JSON line: for each, both
trees' median, minimum and maximum, the median of the per-pair
differences (this checkout less ``OTHER``) and the share of pairs in
which this checkout was faster.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

TREE = Path(__file__).resolve().parents[1]
REPS = 60
LAYERS = 32
MODULES = ("core.serving", "models.config", "ops._build",
           "ops.flash_attention", "serve.engine")


def load(tree: Path) -> dict:
    """The port's modules imported from ``tree``, kept after the package
    leaves ``sys.modules``."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "kubeflow_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(tree))
    try:
        mods = {n: importlib.import_module(f"kubeflow_tpu_torch.{n}")
                for n in MODULES}
    finally:
        sys.path.remove(str(tree))
    mods["ops._build"].build_all()
    return mods


def compare(a: list[float], b: list[float]) -> dict:
    """``a`` (this checkout) against ``b`` (``OTHER``), pair by pair."""
    diff = [x - y for x, y in zip(a, b)]

    def summary(xs):
        return {"median": statistics.median(xs), "min": min(xs),
                "max": max(xs)}

    return {"this": summary(a), "other": summary(b),
            "diff_median": statistics.median(diff),
            "this_faster_share": sum(d < 0 for d in diff) / len(diff)}


def interleave(fns: tuple, reps: int, measure) -> tuple[list, list]:
    """``measure(fn)`` of ``fns = (this, other)`` over ``reps`` pairs, the
    order alternating (B, A, A, B, ...)."""
    out = ([], [])
    for r in range(reps):
        order = (1, 0) if r % 2 == 0 else (0, 1)
        for i in order:
            out[i].append(measure(fns[i]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_prefill_ab: no CUDA device", file=sys.stderr)
        return 2
    other = load(Path(args.other).resolve())
    this = load(TREE)
    cfg = this["models.config"].preset("llama3-8b", n_layers=LAYERS)
    engine = this["serve.engine"].LLMEngine(
        cfg, this["core.serving"].BatchingSpec(
            max_batch_size=8, max_seq_len=2048, prefill_attn_impl="pallas",
            chunked_prefill_tokens=1024, weights_dtype="bfloat16"),
        seed=0, device="cuda")
    dev = engine.device
    toks = torch.randint(3, 259, (1, 2048), device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    slot = torch.zeros((1,), dtype=torch.long, device=dev)
    plen = torch.full((1,), 2048, device=dev)
    cfgs = (cfg, other["models.config"].preset("llama3-8b",
                                                n_layers=LAYERS))
    prefill = tuple(
        (lambda m=m, c=c: m["serve.engine"]._prefill_step(
            engine.params, engine.cache, toks, slot, plen, c, "pallas"))
        for m, c in zip((this, other), cfgs))
    out = {"card": torch.cuda.get_device_name(0), "layers": LAYERS,
           "reps": REPS, "this": str(TREE), "other": args.other}
    with torch.no_grad():
        logits = [fn() for fn in prefill]
        out["prefill_logits_equal"] = bool(torch.equal(*logits))
        for _ in range(2):
            for fn in prefill:
                fn()
        torch.cuda.synchronize()

        def timed(fn):
            t0 = time.perf_counter()
            fn()
            enq = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            return enq, (time.perf_counter() - t0) * 1e3

        got = interleave(prefill, REPS, timed)
    for i, key in enumerate(("prefill_enqueue_ms", "prefill_wall_ms")):
        out[key] = compare(*([t[i] for t in ts] for ts in got))

    q = torch.randn((1, 2048, cfg.n_heads, cfg.head_dim), device=dev).to(
        torch.bfloat16)
    k = torch.randn((1, 2048, cfg.n_kv_heads, cfg.head_dim),
                    device=dev).to(torch.bfloat16)
    for mode in ("no_grad", "graph"):
        qg = q.clone().requires_grad_(mode == "graph")
        calls = tuple(
            (lambda m=m: m["ops.flash_attention"].flash_attention(qg, k, k))
            for m in (this, other))

        def batch(fn):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            us = (time.perf_counter() - t0) * 1e6 / 200
            torch.cuda.synchronize()
            return us

        with torch.set_grad_enabled(mode == "graph"):
            for fn in calls:
                for _ in range(20):
                    fn()
            torch.cuda.synchronize()
            out[f"flash_attention_{mode}_host_us"] = compare(
                *interleave(calls, REPS // 2, batch))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
