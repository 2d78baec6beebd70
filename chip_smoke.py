#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and exits nonzero — printing no result — without one, or when the
package is not beside it. Phases, each a hard failure:

1. card: the ``nvidia-smi`` name and power limit;
2. build: every hand-written kernel built from the checkout's sources (one
   ``nvcc`` per CUDA source, the Triton kernels compiled meanwhile);
3. kernels: each kernel against its plain PyTorch version on the card at
   the Llama-3-8B serving shapes, with its time, the plain version's, one
   library call's where there is one, and the least time the card could
   take (the larger of bytes over 3.35 TB/s and operations over the peak
   rate of their type, H100 SXM); then each kernel against its plain
   version at edge shapes (ragged lengths, q_offset, head_dim 64,
   non-causal, one query row, odd widths, strided inputs; for paged
   decode: length 0, page boundaries, unmapped and poisoned pages, a dead
   row, one and eight query heads per kv head, pages of 16, int8 scale
   outliers);
4. serve: Llama-3-8B at full width and depth (32 layers, random bf16
   weights from a seed) behind the port's ModelServer; greedy completions
   that land in the 128/512/2048 prefill buckets, a chunked-prefill prompt,
   a streamed completion, a v1 predict and a top-k/top-p sampled completion
   over HTTP. Every kernel must have
   launched during this phase; then the bucketed prefill's last-token
   logits are held against the plain path's;
5. paged serve: the same weights on the page pool (bf16 pages, then int8
   pages) behind a ModelServer: shared-prefix, chunked, streamed, predict
   and sampled requests at once, then a second conversation turn and a
   prompt that diverges inside a registered page. Every kernel of the path
   must launch, the radix prefix index must hit and copy a tail,
   ``/metrics`` must show resident pages and no page may leak; then one
   decode step through the paged kernel is held against the gather path
   (bf16 and int8 pages) after a 1000-token paged prefill;
6. profile: host and device time of one decode dispatch on the contiguous
   cache and on the page pool, and of one 2048-token prefill, with the
   kernels that take the device time;
7. train check (serving engines freed first): Llama-3-8B at full width, 4
   layers, one ``decoder_loss`` forward and backward through the flash
   kernels (``attn_impl="pallas"``) against the plain attention on the
   same weights and batch — loss and the layer-0 wq/wk/wv and embedding
   gradients — then three steps on a repeated batch must lower the loss;
8. train: the same model through ``Trainer.run()`` (fp32 params, AdamW,
   ``fused_kernels="off"``, ``nothing_saveable`` remat, chunked CE,
   synthetic 2 x 2048 batches): 6 steps uninterrupted, then 3 steps that
   checkpoint at step 3 and crash, then a second ``Trainer`` that resumes
   from step 3 and finishes; loss and grad norm finite every step, the
   resumed step-6 loss within 1e-5 relative of the uninterrupted one, the
   same optimizer count and the same layer-0 ``wq`` Adam moments at step 6,
   and
   per step 8 flash forward launches (forward and remat replay) and 4 of
   each backward kernel; then a profile of one training step.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
one JSON object with every kernel's numbers.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
SEED = 0

# |kernel - plain| <= ATOL + RTOL * |plain|, elementwise: one bf16 rounding
# of the output (2^-7 relative, with an absolute floor near zero) — the two
# versions round fp32 intermediates at different places. lse is fp32.
RTOL, ATOL = 2.0 ** -7, 1e-2
LSE_ATOL = 1e-3
# Last-token logits of a bucketed prefill, kernel path vs plain path, both
# bf16 over 32 layers: relative L2 error.
PREFILL_REL_L2 = 5e-2
# Flash backward kernels vs their plain version at the training shape:
# relative L2 error over the whole output, beside the elementwise check.
BWD_REL_L2 = 1e-2
# Training check, kernel path vs plain attention, 4 layers of random bf16
# activations: loss (relative) and gradients (relative L2).
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
# Resumed run vs the uninterrupted one at step 6: the loss (relative) and
# the layer-0 wq Adam moments (relative L2). Both runs do the same work on
# the same inputs and have read bit-equal; the bands leave room for a
# reduction order that changes between runs. A resume that lost the moments
# misses half of their six terms and is off by tens of percent.
RESUME_LOSS_REL = 1e-5
RESUME_MOMENT_REL_L2 = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph and replayed ``reps`` times between CUDA events. Replay has no
    host launch gaps (a Triton launch costs tens of microseconds on the
    host, more than these kernels run), so this is the work's own time."""
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


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def within(out: torch.Tensor, ref: torch.Tensor, name: str,
           atol: float = ATOL, rtol: float = RTOL) -> float:
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if not torch.all(diff <= atol + rtol * ref.float().abs()):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, tolerance {atol:g} + {rtol:g}*|ref|)")
    return err


# -- phases --------------------------------------------------------------------

def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return line


def phase_build() -> None:
    from kubeflow_tpu_torch.ops import _build, fused_norm
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    errors: list[BaseException] = []

    def nvcc():
        try:
            _build.build_all()
        except BaseException as exc:          # re-raised on the main thread
            errors.append(exc)

    th = threading.Thread(target=nvcc, name="nvcc")
    th.start()
    # Triton compiles in this process while nvcc runs: one call per kernel
    # specialisation the serve path uses (bf16, D = 4096, silu).
    x = torch.ones((8, 4096), dtype=torch.bfloat16, device="cuda")
    w = torch.ones((4096,), dtype=torch.bfloat16, device="cuda")
    fused_norm.rmsnorm_fused(x, w, eps=1e-5)
    fused_norm.add_rmsnorm_fused(x, x, w, eps=1e-5)
    fused_norm.swiglu_fused(x, x, act="silu")
    th.join()
    if errors:
        raise errors[0]
    q = torch.zeros((1, 64, 32, 128), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((1, 64, 8, 128), dtype=torch.bfloat16, device="cuda")
    flash_attention(q, k, k)
    torch.cuda.synchronize()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, in parallel: "
          f"{', '.join(_build.SOURCES)}; triton: rms_fwd, swiglu_fwd)",
          flush=True)
    for name, log in _build.PTXAS.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)


def phase_kernels() -> list[dict]:
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import fused_norm as fn
    from kubeflow_tpu_torch.ops.flash_attention import (
        flash_attention, flash_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    D, M, eps = 4096, 14336, 1e-5
    rows = []

    # Sites 1 and 2: RMSNorm, residual + RMSNorm — decode (T=8) and
    # bucketed prefill (T=2048); the prefill shape is the one recorded.
    errs = {"rmsnorm_fwd": 0.0, "add_rmsnorm_fwd": 0.0}
    for T in (8, 2048):
        x, res, w = rnd(T, D), rnd(T, D), rnd(D)
        e1 = within(fn.rmsnorm_fused(x, w, eps=eps),
                    fn.rmsnorm_ref(x, w, eps=eps), f"rmsnorm T={T}")
        y, o = fn.add_rmsnorm_fused(x, res, w, eps=eps)
        yr, orf = fn.add_rmsnorm_ref(x, res, w, eps=eps)
        e2 = max(within(y, yr, f"add_rmsnorm y T={T}"),
                 within(o, orf, f"add_rmsnorm o T={T}"))
        errs["rmsnorm_fwd"] = max(errs["rmsnorm_fwd"], e1)
        errs["add_rmsnorm_fwd"] = max(errs["add_rmsnorm_fwd"], e2)
        print(f"kernel rmsnorm_fwd T={T} D={D}: max_abs_err {e1:.3e}; "
              f"add_rmsnorm_fwd: max_abs_err {e2:.3e} "
              f"(tolerance {ATOL:g} + {RTOL:g}*|ref|)", flush=True)
    T = 2048
    x, res, w = rnd(T, D), rnd(T, D), rnd(D)
    b_rms = bound(2 * T * D * 2 + D * 2 + T * 4, 4 * T * D, FP32_FLOPS)
    rows.append(dict(
        name="rmsnorm_fwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:120",
        max_abs_err=errs["rmsnorm_fwd"],
        ms=device_ms(lambda: fn.rmsnorm_fused(x, w, eps=eps)),
        plain_ms=device_ms(lambda: fn.rmsnorm_ref(x, w, eps=eps)),
        bound_ms=b_rms[0], bound_by=b_rms[1],
        library_ms=device_ms(lambda: F.rms_norm(x, (D,), w, eps))))
    b_add = bound(4 * T * D * 2 + D * 2 + T * 4, 5 * T * D, FP32_FLOPS)
    rows.append(dict(
        name="add_rmsnorm_fwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:129",
        max_abs_err=errs["add_rmsnorm_fwd"],
        ms=device_ms(lambda: fn.add_rmsnorm_fused(x, res, w, eps=eps)),
        plain_ms=device_ms(lambda: fn.add_rmsnorm_ref(x, res, w, eps=eps)),
        bound_ms=b_add[0], bound_by=b_add[1], library_ms=None))

    # Site 4: SwiGLU at the prefill shape (and GeGLU for the gelu branch).
    g, u = rnd(T, M), rnd(T, M)
    e_sw = within(fn.swiglu_fused(g, u, act="silu"),
                  fn.swiglu_ref(g, u, act="silu"), "swiglu silu")
    e_ge = within(fn.swiglu_fused(g, u, act="gelu"),
                  fn.swiglu_ref(g, u, act="gelu"), "swiglu gelu")
    print(f"kernel swiglu_fwd T={T} M={M}: max_abs_err silu {e_sw:.3e}, "
          f"gelu {e_ge:.3e}", flush=True)
    b_sw = bound(3 * T * M * 2, 6 * T * M, FP32_FLOPS)
    rows.append(dict(
        name="swiglu_fwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:283",
        max_abs_err=max(e_sw, e_ge),
        ms=device_ms(lambda: fn.swiglu_fused(g, u, act="silu")),
        plain_ms=device_ms(lambda: fn.swiglu_ref(g, u, act="silu")),
        bound_ms=b_sw[0], bound_by=b_sw[1],
        library_ms=device_ms(lambda: F.silu(g) * u)))

    # Site 6: flash forward, B=1 H=32 KH=8 S=2048 D=128 causal (+ softcap).
    B, H, KH, S, Dh = 1, 32, 8, 2048, 128
    q, k, v = rnd(B, S, H, Dh), rnd(B, S, KH, Dh), rnd(B, S, KH, Dh)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    e_fl = 0.0
    for cap in (None, 30.0):
        o, lse = flash_attention(q, k, v, causal=True, logits_softcap=cap)
        ro, rl = flash_ref(qt, kt, vt, causal=True, sm_scale=Dh ** -0.5,
                           softcap=cap, q_offset=0)
        e_o = within(o, ro.transpose(1, 2), f"flash o softcap={cap}")
        e_l = within(lse, rl, f"flash lse softcap={cap}", atol=LSE_ATOL,
                     rtol=0.0)
        e_fl = max(e_fl, e_o)
        print(f"kernel flash_fwd B={B} H={H} KH={KH} S={S} D={Dh} causal "
              f"softcap={cap}: max_abs_err o {e_o:.3e}, lse {e_l:.3e}",
              flush=True)
    causal_pairs = S * (S + 1) / 2
    b_fl = bound(2 * (B * S * H * Dh * 2) + 2 * (B * S * KH * Dh * 2)
                 + B * H * S * 4, 4 * B * H * causal_pairs * Dh, BF16_FLOPS)
    rows.append(dict(
        name="flash_fwd", route="cuda",
        source="kubeflow_tpu_torch/csrc/flash_fwd.cu",
        replaces="kubeflow_tpu/ops/flash_attention.py:156",
        max_abs_err=e_fl,
        ms=device_ms(lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=device_ms(lambda: flash_ref(qt, kt, vt, causal=True,
                                             sm_scale=Dh ** -0.5,
                                             softcap=None, q_offset=0),
                           iters=2, reps=3),
        bound_ms=b_fl[0], bound_by=b_fl[1],
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))))
    rows += flash_bwd_rows()
    rows += paged_kernel_rows()
    for r in rows:
        print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return rows


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref.float()).norm() / ref.float().norm())


def bwd_case(gen, B, H, KH, Sq, Skv, D, *, causal=True, q_offset=0,
             softcap=None):
    """Inputs of one flash-backward call on the kernel layout: bf16 q, k,
    v and dO; lse and delta from the plain forward (fp32)."""
    from kubeflow_tpu_torch.ops import flash_attention as FA

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(B, H, Sq, D), rnd(B, KH, Skv, D), rnd(B, KH, Skv, D), \
        rnd(B, H, Sq, D)
    kw = dict(causal=causal, sm_scale=D ** -0.5, softcap=softcap,
              q_offset=q_offset)
    o, lse = FA.flash_ref(q, k, v, **kw)
    return (q, k, v, do, lse, FA._delta(o, do)), kw


def check_bwd(args, kw, name: str) -> tuple[dict, float, tuple]:
    """Both backward kernels against the plain backward on ``args``:
    ({"dq", "dk", "dv": max abs error}, worst relative L2, the kernels'
    outputs)."""
    from kubeflow_tpu_torch.ops import flash_attention as FA

    dk, dv = FA.flash_bwd_dkdv(*args, **kw)
    dq = FA.flash_bwd_dq(*args, **kw)
    ref = FA._bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    errs, rel = {}, 0.0
    for part, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        errs[part] = within(got, want, f"{name} {part}")
        if float(want.float().norm()) > 0:
            rel = max(rel, rel_l2(got, want))
    return errs, rel, (dq, dk, dv)


def flash_bwd_rows() -> list[dict]:
    """Sites 7 and 8: the dK/dV and dQ kernels against the plain backward
    at the training shape (B=2, H=32, KH=8, S=2048, D=128, causal). The
    plain version and the library call (the backward of SDPA) each compute
    dq, dk and dv together; their times stand in both rows."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator("cuda").manual_seed(SEED + 6)
    B, H, KH, S, D = 2, 32, 8, 2048, 128
    args, kw = bwd_case(gen, B, H, KH, S, S, D)
    errs, rel, _ = check_bwd(args, kw, "flash_bwd S=2048")
    print(f"kernel flash_bwd B={B} H={H} KH={KH} S={S} D={D} causal: "
          f"max_abs_err dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv "
          f"{errs['dv']:.3e}, worst rel L2 {rel:.3e} (tolerance "
          f"{BWD_REL_L2:g})", flush=True)
    if not rel <= BWD_REL_L2:
        fail(f"flash backward kernels: rel L2 {rel:.3e} > {BWD_REL_L2:g}")
    plain_ms = device_ms(lambda: FA._bwd_ref(*args, **kw), iters=2, reps=3)
    # The library yardstick: SDPA's backward on the same tensors.
    q, k, v, do = (t.detach().clone().requires_grad_(i < 3)
                   for i, t in enumerate(args[:4]))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    grad = lambda: torch.autograd.grad(out, (q, k, v), do,  # noqa: E731
                                       retain_graph=True)
    for _ in range(3):
        grad()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(10):
        grad()
    t1.record()
    t1.synchronize()
    library_ms = t0.elapsed_time(t1) / 10
    pairs = S * (S + 1) / 2                      # causal (q, k) pairs
    product = 2.0 * B * H * pairs * D            # one product's FLOPs
    in_bytes = 2 * (B * H * S * D * 2) + 2 * (B * KH * S * D * 2) \
        + 2 * (B * H * S * 4)
    rows = []
    for name, n_products, out_bytes, fn, site, err in (
            ("flash_bwd_dkdv", 4, 2 * B * KH * S * D * 2,
             lambda: FA.flash_bwd_dkdv(*args, **kw), 331,
             max(errs["dk"], errs["dv"])),
            ("flash_bwd_dq", 3, B * H * S * D * 2,
             lambda: FA.flash_bwd_dq(*args, **kw), 372, errs["dq"])):
        b = bound(in_bytes + out_bytes, n_products * product, BF16_FLOPS)
        rows.append(dict(
            name=name, route="cuda",
            source="kubeflow_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"kubeflow_tpu/ops/flash_attention.py:{site}",
            max_abs_err=err, ms=device_ms(fn), plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=library_ms))
    return rows


def paged_case(gen, B, H, KH, D, page, lengths, *, quant=False, mpp=None,
               spare=3, unmapped=()):
    """Inputs of one paged-decode call: bf16 q, a pool with ``spare`` pages
    no table names (plus the engine's sink page last), a table that scatters
    each slot's pages over the pool in random order, and ``lengths``.
    ``unmapped`` lists (slot, page slot) entries set to -1. An int8 pool is
    quantized from bf16 K/V by ``quantize_kv``, as the engine writes it."""
    from kubeflow_tpu_torch.ops.quantization import quantize_kv

    mpp = mpp or max(-(-(int(max(lengths)) + 1) // page), 1)
    P = B * mpp + spare + 1
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((P, page, KH, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((P, page, KH, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    perm = torch.argsort(torch.rand(B * mpp, generator=gen, device="cuda"))
    table = perm.reshape(B, mpp).to(torch.int32)
    for b, j in unmapped:
        table[b, j] = -1
    lens = torch.tensor(lengths, dtype=torch.int64, device="cuda")
    case = {"q": q, "pool_k": k, "pool_v": v, "table": table, "lengths": lens}
    if quant:
        case["pool_k"], case["pool_ks"] = quantize_kv(k)
        case["pool_v"], case["pool_vs"] = quantize_kv(v)
    return case


def paged_call(fn, case):
    return fn(case["q"], case["pool_k"], case["pool_v"], case["table"],
              case["lengths"], pool_ks=case.get("pool_ks"),
              pool_vs=case.get("pool_vs"))


def paged_bytes(case) -> int:
    """Bytes one call must move: the K/V rows (and int8 scales) of every
    position 0..lengths[b] of every slot, read once, plus q, the table,
    the lengths and the output."""
    _, page, KH, D = case["pool_k"].shape
    pos = int((case["lengths"] + 1).sum())
    row = 2 * KH * D * case["pool_k"].element_size()
    if "pool_ks" in case:
        row += 2 * KH * 4
    q = case["q"]
    return (pos * row + 2 * q.numel() * q.element_size()
            + case["table"].numel() * 4 + case["lengths"].numel() * 8)


def paged_flops(case) -> float:
    """QK and PV products over every attended position (2 FLOP each per
    multiply-add), in fp32 on the CUDA cores."""
    _, _, H, D = case["q"].shape
    return 4.0 * H * D * float((case["lengths"] + 1).sum())


def paged_kernel_rows() -> list[dict]:
    """Site 12: the paged-decode kernel against its plain version at the
    serving shape (8 slots, 32 query over 8 kv heads of 128, pages of
    128), bf16 and int8 pools. The recorded time is at length 2047, whose
    ~67 MB of bf16 K/V exceeds the 50 MB L2; length 1024 (~34 MB, served
    from L2 on back-to-back replays) is printed beside it."""
    from kubeflow_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    B, H, KH, D, page = 8, 32, 8, 128, 128
    rows = []
    for name, quant in (("paged_decode", False), ("paged_decode_int8", True)):
        err, timed = 0.0, None
        for length in (2047, 1024):
            case = paged_case(gen, B, H, KH, D, page, [length] * B,
                              quant=quant, mpp=16)
            e = within(paged_call(paged_decode_attention, case),
                       paged_call(paged_decode_ref, case),
                       f"{name} length {length}")
            err = max(err, e)
            ms = device_ms(lambda: paged_call(paged_decode_attention, case))
            b = bound(paged_bytes(case), paged_flops(case), FP32_FLOPS)
            print(f"kernel {name} B={B} H={H} KH={KH} D={D} page={page} "
                  f"length={length}: max_abs_err {e:.3e}, ms {ms:.4f}, "
                  f"bound_ms {b[0]:.4f} ({b[1]}, "
                  f"{paged_bytes(case) / 1e6:.1f} MB"
                  f"{', fits the 50 MB L2' if length == 1024 else ''})",
                  flush=True)
            if timed is None:
                timed = (case, ms, b)
        case, ms, b = timed
        rows.append(dict(
            name=name, route="cuda",
            source="kubeflow_tpu_torch/csrc/paged_decode.cu",
            replaces="kubeflow_tpu/ops/paged_attention.py:169",
            max_abs_err=err, ms=ms,
            plain_ms=device_ms(lambda: paged_call(paged_decode_ref, case),
                               iters=2, reps=3),
            bound_ms=b[0], bound_by=b[1],
            # No single PyTorch call attends over a page table.
            library_ms=None))
    return rows


def phase_edges() -> None:
    """The kernels away from the serving shapes, each against its plain
    version: ragged edges (lengths not a multiple of a tile or block), a
    static q_offset, head_dim 64, a non-causal Sq != Skv block with softcap
    and an explicit scale, one query row, the (1 + w) norm, odd widths and
    strided inputs."""
    from kubeflow_tpu_torch.ops import fused_norm as fn
    from kubeflow_tpu_torch.ops.flash_attention import (
        flash_attention, flash_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    for T, D, plus_one in ((1, 4096, True), (37, 1000, False),
                           (5, 3072, True)):
        x, res, w = rnd(T, D), rnd(T, D), rnd(D)
        e = within(fn.rmsnorm_fused(x, w, eps=1e-6, plus_one=plus_one),
                   fn.rmsnorm_ref(x, w, eps=1e-6, plus_one=plus_one),
                   f"rmsnorm T={T} D={D}")
        y, o = fn.add_rmsnorm_fused(x, res, w, eps=1e-6, plus_one=plus_one)
        yr, orf = fn.add_rmsnorm_ref(x, res, w, eps=1e-6, plus_one=plus_one)
        e = max(e, within(y, yr, f"add_rmsnorm y T={T} D={D}"),
                within(o, orf, f"add_rmsnorm o T={T} D={D}"))
        print(f"edge norms T={T} D={D} plus_one={plus_one}: max_abs_err "
              f"{e:.3e}", flush=True)
    wide = rnd(6, 2 * 1000)
    g, u = wide[:, :1000], wide[:, 1000:]          # strided views
    for act in ("silu", "gelu"):
        e = within(fn.swiglu_fused(g, u, act=act),
                   fn.swiglu_ref(g, u, act=act), f"swiglu {act} 6x1000")
        print(f"edge swiglu {act} [6, 1000] strided: max_abs_err {e:.3e}",
              flush=True)

    # (B, H, KH, Sq, Skv, D, causal, q_offset, softcap, sm_scale)
    cases = ((2, 4, 2, 200, 200, 128, True, 0, None, None),
             (1, 8, 8, 130, 200, 64, True, 70, None, None),
             (1, 8, 2, 77, 333, 128, False, 0, 20.0, 0.1),
             (3, 32, 8, 1, 517, 128, True, 516, None, None))
    for B, H, KH, Sq, Skv, Dh, causal, off, cap, scale in cases:
        q, k, v = rnd(B, Sq, H, Dh), rnd(B, Skv, KH, Dh), rnd(B, Skv, KH, Dh)
        o, lse = flash_attention(q, k, v, causal=causal, q_offset=off,
                                 logits_softcap=cap, sm_scale=scale)
        ro, rl = flash_ref(*(t.transpose(1, 2).contiguous()
                             for t in (q, k, v)),
                           causal=causal, sm_scale=scale or Dh ** -0.5,
                           softcap=cap, q_offset=off)
        name = (f"flash B={B} H={H} KH={KH} Sq={Sq} Skv={Skv} D={Dh} "
                f"causal={causal} q_offset={off} softcap={cap}")
        e_o = within(o, ro.transpose(1, 2), name)
        e_l = within(lse, rl, name + " lse", atol=LSE_ATOL, rtol=0.0)
        print(f"edge {name}: max_abs_err o {e_o:.3e}, lse {e_l:.3e}",
              flush=True)
    phase_flash_bwd_edges()
    phase_paged_edges()


def phase_flash_bwd_edges() -> None:
    """The two backward kernels against the plain backward away from the
    training shape: S = 1, 63, 64, 65, 1000 and 2047 (ragged tiles),
    head_dim 64, one and eight query heads per kv head, softcap, Sq < Skv
    at q_offset = Skv - Sq, a non-causal block, and rows that see no key
    (negative q_offset: lse is NEG_INF, the gradient must be zero)."""
    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    # (B, H, KH, Sq, Skv, D, causal, q_offset, softcap)
    cases = ((1, 8, 2, 1, 1, 128, True, 0, None),
             (1, 8, 2, 63, 63, 128, True, 0, None),
             (1, 8, 2, 64, 64, 64, True, 0, None),
             (1, 8, 8, 65, 65, 128, True, 0, None),
             (1, 8, 1, 1000, 1000, 128, True, 0, 30.0),
             (1, 4, 2, 2047, 2047, 128, True, 0, None),
             (2, 4, 2, 300, 1000, 64, True, 700, None),
             (1, 4, 2, 200, 200, 128, False, 0, 20.0),
             (1, 4, 2, 128, 128, 64, True, -5, None))
    for B, H, KH, Sq, Skv, D, causal, off, cap in cases:
        args, kw = bwd_case(gen, B, H, KH, Sq, Skv, D, causal=causal,
                            q_offset=off, softcap=cap)
        name = (f"flash_bwd B={B} H={H} KH={KH} Sq={Sq} Skv={Skv} D={D} "
                f"causal={causal} q_offset={off} softcap={cap}")
        errs, rel, (dq, _, _) = check_bwd(args, kw, name)
        note = ""
        if off < 0:
            if torch.count_nonzero(dq[:, :, :-off]):
                fail(f"{name}: rows that see no key have a nonzero dq")
            note = "; rows with no key give zero dq"
        print(f"edge {name}: max_abs_err {max(errs.values()):.3e}, rel L2 "
              f"{rel:.3e}{note}", flush=True)


def phase_paged_edges() -> None:
    """The paged-decode kernel against its plain version away from the
    serving shape: length 0, lengths on and one short of page boundaries,
    unmapped table entries, a dead row (no mapped page: zeros), pages no
    table names poisoned with 999 (the output must not move), head_dim 64,
    one and eight query heads per kv head, pages of 16, and int8 pools
    whose scale planes carry outliers."""
    from kubeflow_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    # (B, H, KH, D, page, lengths, quant, unmapped (slot, page slot))
    cases = (
        (6, 32, 8, 128, 128, [0, 127, 128, 255, 256, 1000], False,
         ((5, 3),)),
        (6, 32, 8, 128, 128, [0, 127, 128, 255, 256, 1000], True,
         ((5, 3),)),
        (3, 8, 8, 64, 16, [15, 16, 100], False, ((2, 1),)),
        (3, 64, 8, 128, 16, [31, 32, 299], True, ()),
        (2, 16, 2, 64, 32, [63, 64], True, ()),
        (4, 8, 1, 128, 48, [47, 48, 95, 200], False, ()),
    )
    for B, H, KH, D, page, lengths, quant, unmapped in cases:
        case = paged_case(gen, B, H, KH, D, page, lengths, quant=quant,
                          unmapped=unmapped)
        name = (f"paged_decode B={B} H={H} KH={KH} D={D} page={page} "
                f"lengths={lengths} int8={quant} unmapped={list(unmapped)}")
        if quant:
            # Outlier tokens: a few scale entries 1000x their neighbours.
            for plane in ("pool_ks", "pool_vs"):
                s = case[plane]
                idx = torch.randint(0, s.numel(), (max(s.numel() // 97, 1),),
                                    generator=gen, device="cuda")
                s.view(-1)[idx] *= 1000.0
        out = paged_call(paged_decode_attention, case)
        e = within(out, paged_call(paged_decode_ref, case), name)
        # Pages no table entry names (the spare pages and the sink) hold
        # 999; the output must not move by a bit.
        named = case["table"][case["table"] >= 0].long().unique()
        spare = torch.ones(case["pool_k"].shape[0], dtype=torch.bool,
                           device="cuda")
        spare[named] = False
        poison = 99 if quant else 999          # int8 pages hold at most 127
        for plane in ("pool_k", "pool_v"):
            case[plane][spare] = poison
        for plane in ("pool_ks", "pool_vs"):
            if plane in case:
                case[plane][spare] = 999.0
        if not torch.equal(paged_call(paged_decode_attention, case), out):
            fail(f"{name}: the output moved when unmapped pages changed")
        # A dead row: every table entry unmapped, so the output is zeros.
        case["table"][0] = -1
        dead = paged_call(paged_decode_attention, case)[0]
        if torch.count_nonzero(dead):
            fail(f"{name}: a row with no mapped page is not all zeros")
        print(f"edge {name}: max_abs_err {e:.3e}; poisoned unmapped pages "
              "change nothing; a dead row is zeros", flush=True)


def _post(url: str, body: dict, timeout: float = 600.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def text(n_tokens: int, salt: int) -> str:
    """A prompt of ``n_tokens`` tokens under the byte tokenizer (one token
    per byte plus BOS)."""
    return "".join(chr(97 + (i * 7 + salt) % 26) for i in range(n_tokens - 1))


def _resident_pages(url: str) -> float:
    """``kftpu_engine_kv_pages_resident`` as ``/metrics`` shows it."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
        for ln in resp.read().decode().splitlines():
            if ln.startswith("kftpu_engine_kv_pages_resident"):
                return float(ln.rsplit(" ", 1)[1])
    return 0.0


def serve_http(engine, calls, wrappers: dict, label: str,
               watch_pages: bool = False) -> dict:
    """Serve ``calls`` ([(name, path, body)], all at once) over HTTP from a
    ModelServer in front of ``engine``. Every launch count is set to 0 just
    before and read just after. Each reply must be 200 and each stream
    well-formed SSE; each request must finish with tokens in the
    vocabulary. With ``watch_pages``, ``/metrics`` is polled meanwhile for
    the most KV pages it showed resident."""
    from kubeflow_tpu_torch.serve.server import ModelServer
    from kubeflow_tpu_torch.serve.tokenizer import ByteTokenizer

    submitted = []
    submit = engine.submit

    def recording_submit(*a, **kw):
        req = submit(*a, **kw)
        submitted.append(req)
        return req

    engine.submit = recording_submit
    server = ModelServer("llama3-8b", engine)
    results: dict[str, tuple] = {}
    resident = [0.0]
    done = threading.Event()

    def run(name, path, body):
        try:
            results[name] = _post(server.url + path, body)
        except Exception as exc:          # reported and failed below
            results[name] = (None, repr(exc).encode())

    def watch():
        while not done.is_set():
            try:
                resident[0] = max(resident[0], _resident_pages(server.url))
            except OSError:
                pass                      # the maximum is checked by the caller
            done.wait(0.05)

    for wrapper in wrappers.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    server.start()
    try:
        threads = [threading.Thread(target=run, args=c) for c in calls]
        if watch_pages:
            threads.append(threading.Thread(target=watch))
        for th in threads:
            th.start()
        for th in threads[:len(calls)]:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        snap = engine.metrics.snapshot()
    finally:
        done.set()
        for th in threads[len(calls):]:
            th.join(timeout=60)
        server.stop()
        engine.submit = submit
    for name, path, body in calls:
        status, payload = results.get(name, (None, b"no response"))
        if status != 200:
            fail(f"{label} {name}: HTTP {status}: {payload[:300]!r}")
        if body.get("stream"):
            chunks = [ln for ln in payload.decode().split("\n")
                      if ln.startswith("data: ")]
            if not chunks or chunks[-1] != "data: [DONE]":
                fail(f"{label} {name}: malformed SSE stream")
    by_prompt = {tuple(r.prompt_tokens[:len(r.prompt_tokens)
                                       - r.resumed_from]): r
                 for r in submitted}
    reqs, total = {}, 0
    for name, path, body in calls:
        prompt = body.get("prompt") or body["instances"][0]
        req = by_prompt.get(tuple(ByteTokenizer().encode(prompt)))
        if req is None or not req.done.is_set():
            fail(f"{label} {name}: no finished engine request")
        reqs[name] = req
        n = len(req.output_tokens)
        total += n
        print(f"{label} request {name}: status 200, prompt "
              f"{len(req.prompt_tokens) - req.resumed_from} tokens, {n} "
              f"tokens returned ({req.finish_reason}), ttft "
              f"{req.ttft * 1e3:.1f} ms", flush=True)
        if n == 0 or not all(0 <= t < engine.cfg.vocab_size
                             for t in req.output_tokens):
            fail(f"{label} {name}: bad output tokens {req.output_tokens}")
    print(f"{label}: {len(calls)} requests, {total} tokens in {wall:.2f} s "
          f"({total / wall:.1f} tok/s end to end), engine ttft p50 "
          f"{snap.get('ttft_p50_ms', 0):.1f} ms, tpot p50 "
          f"{snap.get('tpot_p50_ms', 0):.2f} ms, preemptions "
          f"{snap.get('preemptions', 0)}", flush=True)
    print(f"{label} kernels " + json.dumps(launches), flush=True)
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} never launched during {label}")
    return {"reqs": reqs, "results": results, "launches": launches,
            "resident": resident[0]}


def phase_serve(rows: list[dict]):
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import decoder_forward
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    wrappers = {"rmsnorm_fwd": fused_norm.rmsnorm_fused,
                "add_rmsnorm_fwd": fused_norm.add_rmsnorm_fused,
                "swiglu_fwd": fused_norm.swiglu_fused,
                "flash_fwd": flash_attention}
    cfg = preset("llama3-8b")
    t0 = time.perf_counter()
    engine = LLMEngine(cfg, BatchingSpec(
        max_batch_size=8, max_seq_len=2048, prefill_attn_impl="pallas",
        chunked_prefill_tokens=1024, weights_dtype="bfloat16"),
        seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: llama3-8b {cfg.n_layers} layers hidden {cfg.hidden} "
          f"params {cfg.num_params() / 1e9:.2f} B bf16, engine ready in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    calls = [
        ("greedy_100", "/v1/completions",
         {"prompt": text(100, 1), "max_tokens": 16}),
        ("greedy_400", "/v1/completions",
         {"prompt": text(400, 2), "max_tokens": 16}),
        ("greedy_800", "/v1/completions",
         {"prompt": text(800, 3), "max_tokens": 16}),
        ("chunked_1500", "/v1/completions",
         {"prompt": text(1500, 4), "max_tokens": 16}),
        ("stream_300", "/v1/completions",
         {"prompt": text(300, 5), "max_tokens": 16, "stream": True}),
        ("predict_200", "/v1/models/llama3-8b:predict",
         {"instances": [text(200, 6)], "max_tokens": 16}),
        ("sampled_150", "/v1/completions",
         {"prompt": text(150, 7), "max_tokens": 16, "temperature": 0.8,
          "top_k": 50, "top_p": 0.9}),
    ]

    launches = serve_http(engine, calls, wrappers, "serve")["launches"]
    for r in rows:
        if r["name"] in launches:
            r["launches"] = launches[r["name"]]

    # Bucketed prefill through the kernels vs the plain ops, same weights.
    gen = torch.Generator().manual_seed(SEED + 1)
    toks = torch.randint(3, 259, (1, 512), generator=gen).to("cuda")
    import dataclasses
    plain_cfg = dataclasses.replace(cfg, fused_kernels="off")
    with torch.no_grad():
        outs = []
        for c, impl in ((cfg, "pallas"), (plain_cfg, "xla")):
            shape = (c.n_layers, 1, 512, c.n_kv_heads, c.head_dim)
            scratch = {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                        device="cuda"),
                       "v": torch.zeros(shape, dtype=torch.bfloat16,
                                        device="cuda"),
                       "len": 0, "prefill": True}
            logits, _ = decoder_forward(engine.params, toks, c,
                                        kv_caches=scratch, attn_impl=impl)
            outs.append(logits[0, -1].float())
    rel = float((outs[0] - outs[1]).norm() / outs[1].norm())
    same = int(outs[0].argmax()) == int(outs[1].argmax())
    print(f"prefill check: last-token logits kernel path vs plain path, "
          f"rel L2 {rel:.3e} (tolerance {PREFILL_REL_L2:g}), max abs "
          f"{float((outs[0] - outs[1]).abs().max()):.3e}, argmax "
          f"{'agrees' if same else 'differs'}", flush=True)
    if not rel <= PREFILL_REL_L2:
        fail("prefill through the kernels disagrees with the plain path")
    return engine


def paged_engine(engine, **overrides):
    """A paged LLMEngine over the contiguous engine's weights (shared, not
    copied): 8 slots of up to 2048 tokens over a pool of 64 pages of 128,
    chunks of 512, the paged-decode kernel, the radix prefix index."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    spec = dict(paged=True, page_size=128, max_pages=64, max_batch_size=8,
                max_seq_len=2048, chunked_prefill_tokens=512,
                paged_attn_impl="pallas", weights_dtype="bfloat16")
    spec.update(overrides)
    return LLMEngine(engine.cfg, BatchingSpec(**spec), params=engine.params,
                     seed=SEED, device="cuda")


def phase_paged_serve(engine, rows: list[dict]) -> None:
    """The paged path over HTTP: Llama-3-8B on the page pool (bf16 pages,
    then int8 pages). Concurrent requests, three of them sharing a 600-token
    prefix; then a second turn of one conversation (it must match pages)
    and a prompt that leaves a registered one inside a page (copy-on-write
    of the shared tail). Every kernel of the path must launch, the prefix
    index must hit, ``/metrics`` must show resident pages, and no page may
    stay referenced at the end."""
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention

    wrappers = {"rmsnorm_fwd": fused_norm.rmsnorm_fused,
                "add_rmsnorm_fwd": fused_norm.add_rmsnorm_fused,
                "swiglu_fwd": fused_norm.swiglu_fused,
                "paged_decode": paged_decode_attention}
    prefix = text(601, 11)                   # 600 tokens with the BOS
    calls = [
        ("shared_a", "/v1/completions",
         {"prompt": prefix + text(101, 21), "max_tokens": 16}),
        ("shared_b", "/v1/completions",
         {"prompt": prefix + text(101, 22), "max_tokens": 16}),
        ("shared_c", "/v1/completions",
         {"prompt": prefix + text(101, 23), "max_tokens": 16}),
        ("chunked_1500", "/v1/completions",
         {"prompt": text(1500, 4), "max_tokens": 16}),
        ("stream_300", "/v1/completions",
         {"prompt": text(300, 5), "max_tokens": 16, "stream": True}),
        ("predict_200", "/v1/models/llama3-8b:predict",
         {"instances": [text(200, 6)], "max_tokens": 16}),
        ("sampled_150", "/v1/completions",
         {"prompt": text(150, 7), "max_tokens": 16, "temperature": 0.8,
          "top_k": 50, "top_p": 0.9}),
    ]
    t0 = time.perf_counter()
    peng = paged_engine(engine)
    torch.cuda.synchronize()
    dens = peng.kv_pool_density()
    print(f"paged serve: pool of {peng._num_pages} pages of "
          f"{peng.page_size} tokens + the sink, {dens['pool_bytes'] / 1e9:.2f}"
          f" GB, engine ready in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    run = serve_http(peng, calls, wrappers, "paged serve", watch_pages=True)
    launches = run["launches"]
    # One after the other: a second turn of conversation a, then a prompt
    # that leaves conversation b's registered prompt 60 tokens into its
    # sixth page.
    turn1 = calls[0][2]["prompt"]
    said = json.loads(run["results"]["shared_a"][1])["choices"][0]["text"]
    follow = [
        ("turn2_a", {"prompt": turn1 + said + text(51, 31),
                     "max_tokens": 16}),
        ("diverge_b", {"prompt": calls[1][2]["prompt"][:659] + text(101, 41),
                       "max_tokens": 16}),
    ]
    seen = {}
    for name, body in follow:
        before = peng.kv_tier_stats()
        r = serve_http(peng, [(name, "/v1/completions", body)], wrappers,
                       "paged serve")
        for k, v in r["launches"].items():
            launches[k] += v
        after = peng.kv_tier_stats()
        seen[name] = {k: after[k] - before[k]
                      for k in ("tokens_matched", "tokens_cow", "cow_copies")}
        print(f"paged serve {name}: {seen[name]}", flush=True)
    stats = peng.kv_tier_stats()
    snap = peng.metrics.snapshot()
    leaks = peng._allocator.leak_report()
    print(f"paged serve: prefix hits {stats['prefix_hits']} of "
          f"{stats['prefix_queries']} queries, {stats['tokens_matched']} "
          f"tokens matched, {stats['tokens_cow']} COW tokens in "
          f"{stats['cow_copies']} copies, preemptions "
          f"{snap.get('preemptions', 0)}, most pages resident on /metrics "
          f"{run['resident']:.0f}, leak report {leaks}", flush=True)
    print("paged serve kernels " + json.dumps(launches), flush=True)
    if stats["prefix_hits"] <= 0:
        fail("paged serve: the prefix index never hit")
    if seen["turn2_a"]["tokens_matched"] <= 0:
        fail("paged serve: the second turn matched no pages")
    if seen["diverge_b"]["tokens_cow"] <= 0:
        fail("paged serve: the diverging prompt took no copy-on-write tail")
    if run["resident"] <= 0:
        fail("paged serve: /metrics never showed a resident KV page")
    if leaks:
        fail(f"paged serve: pages still referenced at the end: {leaks}")
    del peng
    torch.cuda.empty_cache()

    # int8 pages: four of the requests on a second paged engine.
    qeng = paged_engine(engine, kv_cache_dtype="int8")
    qrun = serve_http(qeng, calls[:3] + calls[4:5], wrappers,
                      "paged int8 serve", watch_pages=True)
    qleaks = qeng._allocator.leak_report()
    print(f"paged int8 serve: {qeng.kv_pool_density()}, prefix hits "
          f"{qeng.kv_tier_stats()['prefix_hits']}, leak report {qleaks}",
          flush=True)
    if qleaks:
        fail(f"paged int8 serve: pages still referenced: {qleaks}")
    del qeng
    torch.cuda.empty_cache()
    for r in rows:
        if r["name"] == "paged_decode":
            r["launches"] = launches["paged_decode"]
        elif r["name"] == "paged_decode_int8":
            r["launches"] = qrun["launches"]["paged_decode"]


def phase_paged_check(engine) -> None:
    """One 1000-token prompt prefilled into pages (``paged_chunk_prefill``),
    then one decode step through the kernel and one through the gather
    path on the same pool, 32 layers: last-token logits within rel L2
    5e-2 with the same argmax. bf16 pages, then int8 pages (the gather path
    dequantizing)."""
    from kubeflow_tpu_torch.serve.paged import (
        _paged_decode_step, context_bucket, paged_chunk_prefill,
    )

    cfg, pg, mpp, chunk, n = engine.cfg, 128, 16, 512, 1000
    gen = torch.Generator().manual_seed(SEED + 5)
    prompt = torch.randint(3, 259, (n,), generator=gen).to("cuda")
    pages = -(-(n + 1) // pg)
    for quant in (False, True):
        shape = (cfg.n_layers, pages + 1, pg, cfg.n_kv_heads, cfg.head_dim)
        dt = torch.int8 if quant else torch.bfloat16
        cache = {"k": torch.zeros(shape, dtype=dt, device="cuda"),
                 "v": torch.zeros(shape, dtype=dt, device="cuda")}
        if quant:
            cache["ks"] = torch.zeros(shape[:-1], device="cuda")
            cache["vs"] = torch.zeros(shape[:-1], device="cuda")
        table = torch.full((1, mpp), -1, dtype=torch.int32, device="cuda")
        table[0, :pages] = torch.arange(pages, dtype=torch.int32)
        with torch.no_grad():
            for start in range(0, n, chunk):
                real = min(chunk, n - start)
                toks = torch.zeros((1, chunk), dtype=torch.int64,
                                   device="cuda")
                toks[0, :real] = prompt[start:start + real]
                logits = paged_chunk_prefill(
                    engine.params, cache, toks, table[0], start, real, cfg,
                    context_pages=context_bucket(start, chunk, pg, mpp))
            nxt = logits[real - 1].argmax().reshape(1)
            outs = {}
            for impl in ("pallas", "gather"):
                outs[impl] = _paged_decode_step(
                    engine.params, {**cache, "table": table}, nxt,
                    torch.tensor([n], device="cuda"),
                    torch.tensor([True], device="cuda"), cfg,
                    attn_impl=impl)[0].float()
        a, b = outs["pallas"], outs["gather"]
        rel = float((a - b).norm() / b.norm())
        same = int(a.argmax()) == int(b.argmax())
        kind = "int8" if quant else "bf16"
        print(f"paged decode check ({kind} pages, {n}-token prompt, "
              f"{cfg.n_layers} layers): last-token logits kernel vs gather, "
              f"rel L2 {rel:.3e} (tolerance {PREFILL_REL_L2:g}), argmax "
              f"{'agrees' if same else 'differs'}", flush=True)
        if not (rel <= PREFILL_REL_L2 and same):
            fail(f"paged decode through the kernel disagrees with the "
                 f"gather path ({kind} pages)")


def _kernel_times(prof) -> tuple[float, list[tuple[str, float, int]]]:
    """(total device ms, [(kernel, device ms, launches)] by time) of the
    CUDA kernels a profile recorded."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    return total, [(e.key, e.self_device_time_total / 1e3, e.count)
                   for e in kernels]


def phase_profile(engine) -> None:
    """Where the serve path's time goes: one 8-step decode dispatch at 8
    live slots (cache position 1024) on the contiguous cache, the same on
    the page pool through the paged-decode kernel, and one 2048-token
    bucketed prefill, each timed on the host (enqueue, and wall to a
    synchronize) and under torch.profiler (device time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.serve import engine as E
    from kubeflow_tpu_torch.serve.paged import paged_decode_multi

    cfg, dev, b = engine.cfg, engine.device, engine.num_slots
    steps = 8
    st = {"tokens": torch.full((b,), 5, device=dev),
          "lengths": torch.full((b,), 1024, device=dev),
          "live": torch.ones((b,), dtype=torch.bool, device=dev),
          "temps": torch.zeros((b,), device=dev),
          "top_k": torch.zeros((b,), dtype=torch.long, device=dev),
          "top_p": torch.ones((b,), device=dev),
          "stops": torch.full((b,), -1, device=dev),
          "budgets": torch.full((b,), 1 << 20, device=dev)}
    names = ("tokens", "lengths", "live", "temps", "top_k", "top_p",
             "stops", "budgets")

    def decode():
        E._decode_multi(engine.params, engine.cache,
                        *(st[n] for n in names), engine._gen, cfg, steps,
                        sample_mode="greedy")

    # The page pool of the paged dispatch: 9 pages of 128 per slot cover
    # positions 0..1031, plus the sink page.
    pg, mpp, per_slot = 128, 16, 9
    shape = (cfg.n_layers, b * per_slot + 1, pg, cfg.n_kv_heads, cfg.head_dim)
    pool = {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "table": torch.full((b, mpp), -1, dtype=torch.int32, device=dev)}
    pool["table"][:, :per_slot] = torch.arange(
        b * per_slot, dtype=torch.int32, device=dev).reshape(b, per_slot)

    def paged_decode():
        paged_decode_multi(engine.params, pool, *(st[n] for n in names),
                           engine._gen, cfg, steps, sample_mode="greedy",
                           attn_impl="pallas")

    toks = torch.randint(3, 259, (1, 2048), device=dev)
    slots = torch.zeros((1,), dtype=torch.long, device=dev)
    plens = torch.full((1,), 2048, device=dev)

    def prefill():
        E._prefill_step(engine.params, engine.cache, toks, slots, plens, cfg,
                        "pallas")

    for name, fn, per in (("decode", decode, steps),
                          ("paged decode", paged_decode, steps),
                          ("prefill", prefill, 1)):
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t_enq = time.perf_counter() - t0
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        total, kernels = _kernel_times(prof)
        unit = "per step" if per > 1 else "per call"
        dev_ms = f"{total / per:.2f}" if total else "not measured"
        print(f"profile {name} ({unit}): host enqueue {t_enq * 1e3 / per:.2f} "
              f"ms, wall {t_wall * 1e3 / per:.2f} ms, device {dev_ms} ms",
              flush=True)
        for key, ms, count in kernels[:6]:
            print(f"  {ms / per:8.3f} ms  {count // per:4d}x  {key[:90]}",
                  flush=True)


TRAIN_MODEL = dict(n_layers=4, fused_kernels="off",
                   remat_policy="nothing_saveable")
TRAIN_DATA = dict(seq_len=2048, global_batch=2)


def _train_wrappers() -> dict:
    from kubeflow_tpu_torch.ops import flash_attention as FA

    return {"flash_fwd": FA.flash_attention,
            "flash_bwd_dkdv": FA.flash_bwd_dkdv,
            "flash_bwd_dq": FA.flash_bwd_dq}


def phase_train_check() -> None:
    """Kernel path vs plain path on the training slice: Llama-3-8B widths,
    4 layers, fp32 params from a seed, one synthetic 2 x 2048 batch; one
    ``decoder_loss`` forward and backward with ``attn_impl="pallas"`` (the
    flash kernels) and with ``"xla"`` (plain attention). Then three steps
    on that batch, repeated, must lower the loss."""
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import decoder_loss
    from kubeflow_tpu_torch.train.data import DataConfig, SyntheticLM
    from kubeflow_tpu_torch.train.optim import OptimizerConfig
    from kubeflow_tpu_torch.train.step import setup_train

    cfg = preset("llama3-8b", **TRAIN_MODEL)
    task = setup_train(cfg, OptimizerConfig(warmup_steps=0, total_steps=10),
                       device="cuda", seed=SEED, attn_impl="pallas")
    batch = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seed=SEED, **TRAIN_DATA)).batch_at(0))
    batch = batch.to("cuda")
    p = task.state["params"]
    attn = p["layers"]["attn"]
    leaves = {"wq[0]": attn["wq"], "wk[0]": attn["wk"], "wv[0]": attn["wv"],
              "embed": p["embed"]}
    got = {}
    for impl in ("pallas", "xla"):
        loss, _ = decoder_loss(p, batch, cfg, attn_impl=impl)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        got[impl] = (loss.item(), {
            name: (g[0] if name != "embed" else g)
            for name, g in zip(leaves, grads)})
        del grads
    (lk, gk), (lp, gp) = got["pallas"], got["xla"]
    loss_rel = abs(lk - lp) / abs(lp)
    rels = {n: rel_l2(gk[n], gp[n]) for n in leaves}
    print(f"train check: loss kernel path {lk:.6f} vs plain {lp:.6f} (rel "
          f"{loss_rel:.3e}, tolerance {TRAIN_LOSS_REL:g}); grad rel L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
          + f" (tolerance {TRAIN_GRAD_REL_L2:g})", flush=True)
    if not loss_rel <= TRAIN_LOSS_REL:
        fail("training loss through the kernels disagrees with the plain path")
    bad = [n for n, r in rels.items() if not r <= TRAIN_GRAD_REL_L2]
    if bad:
        fail(f"training gradients through the kernels disagree: {bad}")
    del got, gk, gp
    losses = []
    for _ in range(3):
        _, m = task.step_fn(task.state, batch)
        losses.append(float(m["loss"]))
    print(f"train check: a repeated batch over 3 steps: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if not losses[-1] < losses[0]:
        fail("three steps on a repeated batch did not lower the loss")
    del task, p, attn, leaves
    gc.collect()
    torch.cuda.empty_cache()


class _Crash(Exception):
    """Ends a training run right after its step-3 checkpoint."""


def _trainer_cfg(ckpt_dir=None):
    from kubeflow_tpu_torch.train.trainer import TrainerConfig

    return TrainerConfig(
        model="llama3-8b", model_overrides=dict(TRAIN_MODEL),
        data=dict(TRAIN_DATA), steps=6, log_every=1, seed=SEED,
        attn_impl="pallas",
        optimizer={"learning_rate": 3e-4, "warmup_steps": 2,
                   "clip_norm": 1.0},
        checkpoint_dir=ckpt_dir, checkpoint_every=3 if ckpt_dir else 0,
        max_checkpoints=1)


def _train_run(cfg, workdir: str, crash_at=None) -> tuple[dict, float]:
    """One ``Trainer.run()``; returns ({step: metrics}, seconds). A
    ``crash_at`` step raises after that step's checkpoint. The last step's
    entry also holds ``opt_state``: the optimizer count and the layer-0 wq
    Adam moments, on the host."""
    from kubeflow_tpu_torch.train.trainer import Trainer

    seen: dict = {}

    def on_step(step, metrics):
        seen[step] = dict(metrics)
        if step == cfg.steps:
            opt = trainer.task.state["opt_state"]
            seen[step]["opt_state"] = {
                "count": int(opt["count"]),
                **{k: opt[k]["layers"]["attn"]["wq"][0].float().cpu()
                   for k in ("mu", "nu")}}
        if step == crash_at:
            raise _Crash()

    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda", workdir=workdir)
    try:
        trainer.run(on_step=on_step)
    except _Crash:
        pass
    finally:
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return seen, time.perf_counter() - t0


def phase_train(rows: list[dict]) -> None:
    """The training slice through its entry point, ``Trainer.run()``."""
    import tempfile

    wrappers = _train_wrappers()
    # Under the checkout (git-ignored), not $TMPDIR: a step-3 checkpoint of
    # this model is 23 GB, more than a small temporary filesystem holds.
    work = tempfile.mkdtemp(prefix=".chip_smoke_train_",
                            dir=Path(__file__).resolve().parent)
    try:
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        for sub in ("whole", "resume"):
            os.makedirs(os.path.join(work, sub))
        whole, secs = _train_run(_trainer_cfg(), os.path.join(work, "whole"))
        launches = {n: w.launches for n, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        for step, m in sorted(whole.items()):
            print(f"train step {step}: loss {m['loss']:.6f} grad_norm "
                  f"{m['grad_norm']:.4f} step_time_ms "
                  f"{m.get('step_time_ms', float('nan')):.1f} tokens/s "
                  f"{m.get('tokens_per_sec', float('nan')):.0f} mfu "
                  f"{m.get('mfu', float('nan')):.4f}", flush=True)
        print(f"train: 6 steps in {secs:.1f} s (init included), peak "
              f"{peak / 2**30:.2f} GiB allocated; kernels "
              + json.dumps(launches), flush=True)
        if sorted(whole) != list(range(1, 7)):
            fail(f"train: steps {sorted(whole)} reported, not 1..6")
        for step, m in whole.items():
            if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                fail(f"train step {step}: non-finite loss or grad norm {m}")
        want = {"flash_fwd": 8 * 6, "flash_bwd_dkdv": 4 * 6,
                "flash_bwd_dq": 4 * 6}
        if launches != want:
            fail(f"train: kernel launches {launches}, expected {want} "
                 "(per step: 8 flash forward, 4 of each backward)")
        for r in rows:
            if r["name"] in ("flash_bwd_dkdv", "flash_bwd_dq"):
                r["launches"] = launches[r["name"]]

        ckpt = os.path.join(work, "ckpt")
        resume_dir = os.path.join(work, "resume")
        first, secs_a = _train_run(_trainer_cfg(ckpt), resume_dir, crash_at=3)
        saved = sorted(os.listdir(ckpt))
        size = sum(os.path.getsize(os.path.join(ckpt, "3", f))
                   for f in os.listdir(os.path.join(ckpt, "3")))
        print(f"train resume: first run stopped after step 3 in "
              f"{secs_a:.1f} s; checkpoint dir {saved}, step 3 holds "
              f"{size / 1e9:.2f} GB", flush=True)
        resumed, secs_b = _train_run(_trainer_cfg(ckpt), resume_dir)
        print(f"train resume: second run resumed and took steps "
              f"{sorted(resumed)} in {secs_b:.1f} s", flush=True)
        if sorted(resumed) != [4, 5, 6]:
            fail(f"train resume: the second run took steps {sorted(resumed)}")
        a, b = whole[6]["loss"], resumed[6]["loss"]
        rel = abs(a - b) / abs(a)
        print(f"train resume: step-6 loss uninterrupted {a:.6f}, resumed "
              f"{b:.6f}, rel {rel:.3e} (tolerance {RESUME_LOSS_REL:g})",
              flush=True)
        if not rel <= RESUME_LOSS_REL:
            fail("train resume: the resumed run diverged")
        sa, sb = whole[6].pop("opt_state"), resumed[6].pop("opt_state")
        moments = {k: rel_l2(sb[k], sa[k]) for k in ("mu", "nu")}
        print(f"train resume: step-6 optimizer count uninterrupted "
              f"{sa['count']}, resumed {sb['count']}; layer-0 wq moments rel "
              f"L2 mu {moments['mu']:.3e}, nu {moments['nu']:.3e} (tolerance "
              f"{RESUME_MOMENT_REL_L2:g})", flush=True)
        if sa["count"] != sb["count"]:
            fail("train resume: the optimizer count was not restored")
        if not all(r <= RESUME_MOMENT_REL_L2 for r in moments.values()):
            fail("train resume: the Adam moments were not restored")
        for step, m in {**first, **resumed}.items():
            if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                fail(f"train resume step {step}: non-finite {m}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_train_profile() -> None:
    """One training step (after two warm ones) at the train phase's
    configuration: host enqueue, wall and device ms, the kernels that take
    the device time, tokens/s and MFU against the card's bf16 peak."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.train.data import DataConfig, SyntheticLM
    from kubeflow_tpu_torch.train.metrics import bf16_peak_flops
    from kubeflow_tpu_torch.train.optim import OptimizerConfig
    from kubeflow_tpu_torch.train.step import setup_train

    cfg = preset("llama3-8b", **TRAIN_MODEL)
    task = setup_train(cfg, OptimizerConfig(), device="cuda", seed=SEED,
                       attn_impl="pallas")
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seed=SEED,
                                 **TRAIN_DATA))
    batches = [torch.from_numpy(src.batch_at(i)).to("cuda") for i in range(4)]
    for b in batches[:2]:
        task.step_fn(task.state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.step_fn(task.state, batches[2])
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        task.step_fn(task.state, batches[3])
        torch.cuda.synchronize()
    total, kernels = _kernel_times(prof)
    tokens = TRAIN_DATA["global_batch"] * TRAIN_DATA["seq_len"]
    tps = tokens / t_wall
    peak = bf16_peak_flops(torch.cuda.get_device_name(0))
    mfu = (f"{cfg.flops_per_token() * tps / peak:.4f}" if peak
           else "not measured (unknown card)")
    dev_ms = f"{total:.2f} ms" if total else "not measured"
    print(f"profile train step (llama3-8b widths, {cfg.n_layers} layers, "
          f"{TRAIN_DATA['global_batch']} x {TRAIN_DATA['seq_len']} tokens): "
          f"host enqueue {t_enq * 1e3:.2f} ms, wall {t_wall * 1e3:.2f} ms, "
          f"device {dev_ms}, {tps:.0f} tokens/s, MFU {mfu}", flush=True)
    for key, ms, count in kernels[:10]:
        print(f"  {ms:8.3f} ms  {count:4d}x  {key[:90]}", flush=True)
    del task, batches
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "kubeflow_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: kubeflow_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    rows = phase_kernels()
    phase_edges()
    engine = phase_serve(rows)
    phase_paged_serve(engine, rows)
    phase_paged_check(engine)
    phase_profile(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serving engines freed: {torch.cuda.memory_allocated() / 2**30:.2f}"
          " GiB still allocated", flush=True)
    phase_train_check()
    phase_train(rows)
    phase_train_profile()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} "
          f"s on {card}", flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
