#!/usr/bin/env python3
"""Where the int8 Mixtral worker's device memory goes, phase by phase, on
one CUDA card: the allocator's memory history around the load, one
dispatch prefill and one dense decode step of the PyTorch port.

    python3 scripts/torch_moe_memory.py

Imports ``kubeflow_tpu_torch`` from the checkout that holds the script
(to compare two trees, run a copy of it from each). Records
``torch.cuda.memory._record_memory_history`` from the first allocation,
then, as the ``model_server`` worker does with ``random://`` and
``quantize: int8``: ``load_params`` of Mixtral-8x7B (all 32 layers;
random bf16 weights, seed 0, packed to int8 per layer),
an ``LLMEngine`` on a page pool (8 slots x 2048, pages of 128, bf16 KV,
512-token prefill windows, prefix caching off), one 500-token greedy
request of 4 new tokens through the engine (the dispatch prefill, then
dense decode), and one dense decode step at 8 slots of position 1024
(``serve.paged._paged_decode_step``), timed: host enqueue, wall to a
synchronize, and device ms from ``torch.profiler``. For each phase it
prints the allocated bytes at its end, its peak, and the largest
``TOP`` groups of the allocations live at that peak that the phase made,
grouped by the innermost frame in the port's package. Then ``estimate_model_bytes`` and the whole run's peak.
The last line is one JSON object with every number.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

GIB = 2 ** 30
TOP = 8


def _where(frames: list) -> str:
    """The innermost frame of an allocation inside the port's package."""
    for f in frames:
        name = f.get("filename", "")
        if "kubeflow_tpu_torch" in name:
            short = name[name.index("kubeflow_tpu_torch"):]
            return f"{short}:{f.get('line')} {f.get('name')}"
    return "(outside the package)"


def phase_report(trace: list, start: int, end: int,
                 base_live: dict) -> dict:
    """Replay ``trace[start:end]`` over the live set ``base_live`` (addr →
    (size, frames, phase-made)); returns the phase's peak live bytes and
    the allocations the phase made that were live at that peak, grouped."""
    live = dict(base_live)
    cur = sum(v[0] for v in live.values())
    peak, at_peak = cur, dict(live)
    for ev in trace[start:end]:
        act = ev["action"]
        if act == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []), True)
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif act in ("free_requested", "free_completed"):
            got = live.pop(ev["addr"], None)
            if got is not None:
                cur -= got[0]
    groups: dict = {}
    for size, frames, made in at_peak.values():
        if made:
            key = _where(frames)
            g = groups.setdefault(key, [0, 0])
            g[0] += size
            g[1] += 1
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])[:TOP]
    ended = {a: (v[0], v[1], False) for a, v in live.items()}
    return {"peak": peak, "end": cur,
            "at_peak": [{"where": k, "bytes": v[0], "count": v[1]}
                        for k, v in ranked]}, ended


def main() -> int:
    tree = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_moe_memory: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.memory._record_memory_history(stacks="python",
                                          max_entries=4_000_000)
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serve.paged import _paged_decode_step
    from kubeflow_tpu_torch.serve.repository import estimate_model_bytes
    from kubeflow_tpu_torch.serve.storage import load_params

    cfg = preset("mixtral-8x7b", param_dtype="bfloat16")
    spec = BatchingSpec(paged=True, page_size=128, max_pages=64,
                        max_batch_size=8, max_seq_len=2048,
                        chunked_prefill_tokens=512, paged_attn_impl="pallas",
                        weights_dtype="bfloat16", quantize="int8",
                        enable_prefix_caching=False)
    marks: list[tuple[str, int]] = []

    def mark(name: str) -> None:
        # One snapshot per phase boundary would copy the whole history:
        # count the trace instead from the final snapshot's markers.
        torch.cuda.synchronize()
        marks.append((name, torch.cuda.memory_allocated()))
        torch.empty(4097 * 1024 + len(marks), dtype=torch.uint8,
                    device="cuda")

    mark("start")
    t0 = time.perf_counter()
    params = load_params("random://", cfg, device="cuda", quantize="int8")
    mark("load")
    t_load = time.perf_counter() - t0
    eng = LLMEngine(cfg, spec, params=params, device="cuda")
    mark("engine")
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(3, cfg.vocab_size, (500,), generator=gen).tolist()
    out = eng.generate(prompt, SamplingParams(max_new_tokens=4))
    mark("request (dispatch prefill, dense decode)")

    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    dcfg = dataclasses.replace(eng._cfg_decode, moe_impl="dense")
    b, pg, mpp = 8, 128, 16
    shape = (cfg.n_layers, b * mpp + 1, pg, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: torch.randn(shape, generator=gen).to(
        device="cuda", dtype=torch.bfloat16) for n in ("k", "v")}
    pool["table"] = torch.arange(b * mpp, dtype=torch.int32,
                                 device="cuda").reshape(b, mpp)
    tokens = torch.randint(3, cfg.vocab_size, (b,), generator=gen).to("cuda")
    lengths = torch.full((b,), 1024, device="cuda")
    live_rows = torch.ones((b,), dtype=torch.bool, device="cuda")
    mark("decode pool")

    def step():
        with torch.no_grad():
            return _paged_decode_step(eng.params, pool, tokens, lengths,
                                      live_rows, dcfg, attn_impl="pallas")

    step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step()
    enq = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    mark("dense decode step")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    whole_peak = torch.cuda.max_memory_allocated()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    cuts = [i for i, ev in enumerate(trace) if ev["action"] == "alloc"
            and 4097 * 1024 < ev["size"] <= 4097 * 1024 + 512]
    if len(cuts) != len(marks):
        print(f"torch_moe_memory: {len(cuts)} markers in the trace, "
              f"{len(marks)} set (history truncated?)", file=sys.stderr)
        return 1
    label = tree
    est = estimate_model_bytes(cfg, spec)
    phases, live = [], {}
    for i in range(1, len(marks)):
        rep, live = phase_report(trace, cuts[i - 1] + 1, cuts[i], live)
        rep["name"] = marks[i][0]
        phases.append(rep)
        print(f"[{label}] phase {rep['name']}: peak {rep['peak'] / GIB:.3f} "
              f"GiB, end {rep['end'] / GIB:.3f} GiB", flush=True)
        for g in rep["at_peak"]:
            print(f"    {g['bytes'] / GIB:8.3f} GiB  {g['count']:5d}x  "
                  f"{g['where']}", flush=True)
    print(f"[{label}] mixtral-8x7b {cfg.n_layers} layers int8: loaded in "
          f"{t_load:.1f} s; whole-run peak {whole_peak / GIB:.3f} GiB "
          f"against estimate_model_bytes {est / GIB:.3f} GiB; dense decode "
          f"step (8 slots at 1024): enqueue {enq:.2f} wall {wall:.2f} device "
          f"{dev:.2f} ms; request tokens {out}", flush=True)
    print(json.dumps({"label": label, "layers": cfg.n_layers,
                      "peak_bytes": whole_peak, "estimate_bytes": est,
                      "decode_enqueue_ms": enq, "decode_wall_ms": wall,
                      "decode_device_ms": dev, "tokens": out,
                      "phases": phases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
