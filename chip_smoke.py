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
   non-causal, one query row, odd widths, strided inputs);
4. serve: Llama-3-8B at full width and depth (32 layers, random bf16
   weights from a seed) behind the port's ModelServer; greedy completions
   that land in the 128/512/2048 prefill buckets, a chunked-prefill prompt,
   a streamed completion, a v1 predict and a top-k/top-p sampled completion
   over HTTP. Every kernel must have
   launched during this phase; then the bucketed prefill's last-token
   logits are held against the plain path's;
5. profile: host and device time of one decode dispatch and one 2048-token
   prefill, with the kernels that take the device time.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
one JSON object with every kernel's numbers.
"""

from __future__ import annotations

import json
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
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc: "
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
    for r in rows:
        print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
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


def _post(url: str, body: dict, timeout: float = 600.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def phase_serve(rows: list[dict]):
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.models.decoder import decoder_forward
    from kubeflow_tpu_torch.ops import fused_norm
    from kubeflow_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_tpu_torch.serve.engine import LLMEngine
    from kubeflow_tpu_torch.serve.server import ModelServer

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
    submitted = []
    submit = engine.submit

    def recording_submit(*a, **kw):
        req = submit(*a, **kw)
        submitted.append(req)
        return req

    engine.submit = recording_submit
    server = ModelServer("llama3-8b", engine)
    results: dict[str, tuple] = {}

    def text(n_tokens: int, salt: int) -> str:
        # Byte tokenizer: one token per byte plus BOS.
        return "".join(chr(97 + (i * 7 + salt) % 26)
                       for i in range(n_tokens - 1))

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

    def run(name, path, body):
        try:
            results[name] = _post(server.url + path, body)
        except Exception as exc:          # reported and failed below
            results[name] = (None, repr(exc).encode())

    for wrapper in wrappers.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    server.start()
    try:
        threads = [threading.Thread(target=run, args=c) for c in calls]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        snap = engine.metrics.snapshot()
    finally:
        server.stop()
    for name, path, body in calls:
        status, payload = results.get(name, (None, b"no response"))
        if status != 200:
            fail(f"{name}: HTTP {status}: {payload[:300]!r}")
        if body.get("stream"):
            chunks = [ln for ln in payload.decode().split("\n")
                      if ln.startswith("data: ")]
            if not chunks or chunks[-1] != "data: [DONE]":
                fail(f"{name}: malformed SSE stream")
    by_len = {len(r.prompt_tokens): r for r in submitted}
    total = 0
    for name, path, body in calls:
        prompt = body.get("prompt") or body["instances"][0]
        req = by_len.get(len(prompt) + 1)
        if req is None or not req.done.is_set():
            fail(f"{name}: no finished engine request")
        n = len(req.output_tokens)
        total += n
        print(f"request {name}: status 200, prompt {len(req.prompt_tokens)} "
              f"tokens, {n} tokens returned ({req.finish_reason}), "
              f"ttft {req.ttft * 1e3:.1f} ms", flush=True)
        if n == 0 or not all(0 <= t < cfg.vocab_size
                             for t in req.output_tokens):
            fail(f"{name}: bad output tokens {req.output_tokens}")
    print(f"serve: {len(calls)} requests, {total} tokens in {wall:.2f} s "
          f"({total / wall:.1f} tok/s end to end), engine ttft p50 "
          f"{snap.get('ttft_p50_ms', 0):.1f} ms, tpot p50 "
          f"{snap.get('tpot_p50_ms', 0):.2f} ms", flush=True)
    print("kernels " + json.dumps(launches), flush=True)
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} never launched during the serve phase")
    for r in rows:
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
    live slots (cache position 1024) and one 2048-token bucketed prefill,
    each timed on the host (enqueue, and wall to a synchronize) and under
    torch.profiler (device time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.serve import engine as E

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

    toks = torch.randint(3, 259, (1, 2048), device=dev)
    slots = torch.zeros((1,), dtype=torch.long, device=dev)
    plens = torch.full((1,), 2048, device=dev)

    def prefill():
        E._prefill_step(engine.params, engine.cache, toks, slots, plens, cfg,
                        "pallas")

    for name, fn, per in (("decode", decode, steps), ("prefill", prefill, 1)):
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
    phase_profile(engine)
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
