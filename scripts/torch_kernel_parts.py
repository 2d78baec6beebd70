#!/usr/bin/env python3
"""Device time of the port's RMSNorm backward and paged decode on one CUDA
card, each call whole and split into its kernels, for comparing two trees
of the port on one machine.

    python3 scripts/torch_kernel_parts.py [--tree DIR] [--label NAME]

Imports ``kubeflow_tpu_torch`` from ``--tree`` (default: this checkout) and
uses only the public wrappers, so a tree from before or after a kernel's
redesign runs the same script:

- ``rmsnorm_bwd`` at T = D = 4096 (bf16 x, dh and dy, the fp32 weight of
  training, seed 0), without and with ``dy``;
- ``paged_decode_attention`` at 8 slots, 32 query heads over 8 kv heads of
  128, pages of 128, 16 page slots, length 2047, bf16 and int8 pages.

For each: the whole call's device time (20 calls captured in a CUDA graph,
replayed 5 times between CUDA events, as ``chip_smoke.py``'s
``device_ms``), and the device time and launches per call of every kernel
that ``torch.profiler`` records over 30 eager calls. Prints the card's
name and power limit, then one JSON line. Run two trees alternately (A, B,
B, A), each in its own process, to compare them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def kernel_parts(fn, calls: int = 30) -> dict:
    """{kernel: {"ms": device ms per call, "launches": per call}} of the
    CUDA kernels ``calls`` eager calls of ``fn`` run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            out[e.key[:80]] = {"ms": e.self_device_time_total / 1e3 / calls,
                               "launches": e.count / calls}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_parts: no CUDA device", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.ops import _build, fused_norm as fn
    from kubeflow_tpu_torch.ops import paged_attention as PA
    from kubeflow_tpu_torch.ops.quantization import quantize_kv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    gen = torch.Generator("cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    result = {"label": args.label, "tree": args.tree, "card": card}
    T = D = 4096
    x, dh, dy = rnd(T, D), rnd(T, D), rnd(T, D)
    w = 1.0 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
    _, _, rstd = fn._norm_launch(x, None, w, 1e-5, False)
    for name, kw in (("rmsnorm_bwd", {}), ("rmsnorm_bwd_dy", {"dy": dy})):
        call = (lambda kw=kw: fn.rmsnorm_bwd(x, w, rstd, dh, **kw))
        result[name] = {"ms": device_ms(call), "kernels": kernel_parts(call)}
    del x, dh, dy

    B, H, KH, Dh, page, mpp, length = 8, 32, 8, 128, 128, 16, 2047
    P = B * mpp + 4
    q = rnd(B, 1, H, Dh)
    k, v = rnd(P, page, KH, Dh), rnd(P, page, KH, Dh)
    perm = torch.argsort(torch.rand(B * mpp, generator=gen, device="cuda"))
    table = perm.reshape(B, mpp).to(torch.int32)
    lengths = torch.full((B,), length, dtype=torch.int64, device="cuda")
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    for name, pools in (("paged_decode", dict(pool_k=k, pool_v=v)),
                        ("paged_decode_int8", dict(pool_k=kq, pool_v=vq,
                                                   pool_ks=ks, pool_vs=vs))):
        def call(pools=pools):
            return PA.paged_decode_attention(
                q, pools["pool_k"], pools["pool_v"], table, lengths,
                pool_ks=pools.get("pool_ks"), pool_vs=pools.get("pool_vs"))
        result[name] = {"ms": device_ms(call), "kernels": kernel_parts(call)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
