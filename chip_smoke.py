#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``kubeflow_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and exits nonzero — printing no result — without one, or when the
package is not beside it. ``python3 chip_smoke.py --flash-only`` runs
phases 1 and 2 and the flash kernels' part of phase 3 (their rows and edge
cases; with ``CUDA_LAUNCH_BLOCKING=1`` a fault names its launch) and
prints no result line; ``--paged-only`` does the same for the paged-decode
kernel, ``--xent-only`` for the fused cross-entropy kernels (their rows
with the cuBLAS yardstick, a repeat call's bits, sink inputs, and their
edge cases), and ``--norm-only`` for the norm and SwiGLU kernels (forward
and backward rows, the RMSNorm backward's kernels timed apart, and their
edge cases); ``--serve-only`` runs phases 1 and 2, serve and (a)–(c),
then (e) and (f), without the kernel rows. Every phase prints its seconds.
Phases, each a hard failure:

1. card: the ``nvidia-smi`` name and power limit;
2. build: every hand-written kernel built from the checkout's sources (one
   ``nvcc`` per CUDA source, the Triton kernels compiled meanwhile), each
   kernel's registers and spills; a spill in the wgmma kernels (flash
   forward, dK/dV, dQ; the fused CE's forward, dl recompute, d_hidden and
   d_head), or a ptxas note that it serialized their wgmma instructions,
   fails;
3. kernels: each kernel against its plain PyTorch version on the card at
   the Llama-3-8B serving and training shapes, with its time, the plain
   version's, one library call's where there is one, and the least time
   the card could take (the larger of bytes over 3.35 TB/s and operations
   over the peak rate of their type, H100 SXM); the fused CE's forward and
   backward beside the chunked CE's and cuBLAS's h W, the d_head product
   beside cuBLAS's h^T dl over the same chunks, two calls of them
   bit-identical, and checked and timed on sink inputs (h = 0; W with
   equal columns) beside the random ones; the flash forward timed on the
   kernel layout, and the dK/dV and dQ kernels each called twice must
   give the same bits; both backward kernels on inputs with an attention
   sink (every query puts p >= 1/2 on key 0), dQ timed there and on the
   random inputs, dK/dV too, with and without its exact-score recompute;
   the RMSNorm backward without and with the residual cotangent, each
   timed whole and per kernel (row pass, dw column sum) beside its bound,
   two calls bit-identical; paged decode with the wrapper's split count
   at 8 slots (1 and 32 printed beside): one kernel launch per call (the
   last split block of each slot and kv head merges the splits), the
   ticket counters zero after every call, and 20 calls in a CUDA graph
   replayed 50 times giving an eager call's bits. Then each kernel
   against its plain version at edge shapes (ragged lengths around the
   flash tiles, a diagonal off a tile boundary, q_offset, rows that see no
   key, head_dim 64, one to eight query heads per kv head, non-causal, one
   query row, odd widths, strided inputs; for
   paged decode: length 0, page boundaries, unmapped and poisoned pages, a
   dead row, one and eight query heads per kv head, pages of 16, int8 scale
   outliers, two calls bit-identical, the counters zero after every call,
   and named split counts (1 to mpp,
   splits past a slot's length, a split all unmapped between counted ones,
   mpp = 13 under counts that do not divide it); for the fused CE: T of 1,
   300 and 4096, D of 1160 (ragged in 64), 2048 and 4096, vocabularies of
   1000, 20000, 128256 and 256000, softcap, argmax ties inside a tile and
   across a vocab-range boundary, targets 0, V-1 and out of vocab, masked
   rows that must get exactly zero d_hidden; for the norm and SwiGLU backward:
   D = 2048/3072/4096, T = 1 and 300, (1 + w), the residual cotangent
   (the RMSNorm backward called twice for the same bits), gelu, odd M, and
   the explainer's T = 37 with a bf16 weight that needs no gradient, timed,
   through the kernels and through the ``autograd.Function``s);
   then the memory probe: the fused CE's forward and
   backward at T = 4096, V = 128256 must peak within one eighth of an
   fp32 [T, V] tensor beyond its inputs and gradients;
4. serve: Llama-3-8B at full width and depth (32 layers, random bf16
   weights from a seed) behind the port's ModelServer; greedy completions
   that land in the 128/512/2048 prefill buckets, a chunked-prefill prompt,
   a streamed completion, a v1 predict and a top-k/top-p sampled completion
   over HTTP. Every kernel must have
   launched during this phase; then the bucketed prefill's last-token
   logits are held against the plain path's;
   (a) explain, on the same engine in process: ``grad_x_input`` on a
   37-token prompt through the kernels against the plain path (same target
   token, scores rel L2 <= 5e-2), with exactly 2L + 1 RMSNorm backward and
   L SwiGLU backward launches; ``leave_one_out`` finite, same target;
   (b) loadgen in process: ``bursty_qos`` of ``standard_matrix`` (24
   requests at 4 req/s, prompts up to 512 tokens, 64 new) through
   ``EngineTarget`` on the contiguous engine; every request ok or shed;
   TTFT, TPOT, req/s, tokens/s and the generator's lag beside the card;
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
   kernels that take the device time; then the greedy tokens of the
   worker's three prompts from an in-process paged engine, and the
   serving engine is freed;
   (c) the worker: ``python -m kubeflow_tpu_torch.runtime.worker_main``
   (``KFTPU_ENTRYPOINT=model_server``, ``KFTPU_PLATFORM=gpu``) serving
   Llama-3-8B from ``random://`` (the same seed, bf16) on the page pool
   with the ``strip`` transformer and the ``grad_x_input`` explainer; its
   kernels found built (no ``nvcc``); its greedy tokens identical to the
   in-process engine's (which proves its kernels ran: the same path
   computed them); chat, streamed and not, and ``:explain`` answer;
   ``uniform`` and ``shared_prefix`` through ``ServerTarget`` with
   ``/metrics`` showing resident pages under load and none after, prefix
   hits in ``shared_prefix``; then ``mixed_interference`` (prompts of
   384, so its batch class's 1536-token prompts fit) against it, every
   request ok; SIGTERM ends it with 143 and closes its port;
7. train check (serving engines freed first): Llama-3-8B at full width, 4
   layers, one ``decoder_loss`` forward and backward through the flash
   kernels alone and through every kernel (``fused_kernels="on"``)
   against the plain path on the same weights and batch — the loss and
   the layer-0 wq/wk/wv, ln1, ln2, gate and up, embedding, final-norm and
   head gradients — then three steps on a repeated batch must lower the
   loss;
8. train: the same model through ``Trainer.run()`` (fp32 params, AdamW,
   the preset's ``fused_kernels="auto"``, which runs every kernel,
   ``nothing_saveable`` remat, synthetic 2 x 2048 batches): 6 steps
   uninterrupted, then 3 steps that checkpoint at step 3 and crash, then a
   second ``Trainer`` that resumes from step 3 and finishes; loss and grad
   norm finite every step, the resumed step-6 loss within 1e-5 relative
   of the uninterrupted one, the same optimizer count and the same layer-0
   ``wq`` Adam moments at step 6, and every kernel of the path launched at
   its per-step count derived from the code;
   (d) ``load_params("file://...")`` of the resumed step-6 checkpoint into
   the 4-layer preset with bf16 params: the same bits as the trainer's
   params cast in memory, the same greedy tokens from an engine on each,
   and ``FileNotFoundError`` for an empty directory; the checkpoint is
   then deleted; then 2 steps with ``fused_kernels="off"`` (flash kernels,
   chunked CE) with their counts; then a profile of one step of each;
9. (e) disaggregated serving and the host KV tier, on a fresh 32-layer
   paged engine (the serving seed): a prefill-role and a decode-role
   engine over its weights hand the worker's three prompts off through
   the wire format, and the tokens must equal the unified engine's (bf16
   pages, then int8 pages), with no page referenced after the acks; a
   host-tier engine (64 host pages) demotes a conversation while idle and
   promotes it on the next turn: the pages' bytes equal before demotion
   and after promotion (bf16, int8 with scales), turn 2's tokens equal an
   engine's without the tier, the paged-decode kernel runs on adopted and
   on promoted pages; ``multi_turn`` (10 s of think time) through
   ``EngineTarget`` on it, no request failing, pages demoted and
   promoted, none left referenced. Then a prefill and a decode worker
   process share the card: the three prompts through the prefill worker
   (the decode worker's URL in ``X-Kftpu-Decode-Backend``) must give the
   worker's tokens; ``mixed_interference`` through them, every request
   ok, one export per request with tokens to decode, as many adoptions,
   no failed or fallback handoff, no page resident after, its report
   beside (c)'s unified one; with the decode worker stopped, a prompt
   must still give its tokens by recompute and the fallback counter read
   1; both workers end with 143 on SIGTERM;
10. (f) the fleet's failure path, on a fresh 32-layer paged engine (the
   serving seed) and a store root in a temporary directory, removed at the
   end: an engine with the host and remote KV tiers (16 host pages, 0.5 s
   to demote and 0.5 s more to spill, a 2 s store deadline) serves a
   700-token turn and spills its five full pages into the artifact store
   while idle, each blob decoding to the page's bytes read before
   demotion; a second engine on the same root serves turn 2 (turn 1, its
   output and 16 tokens) with the greedy tokens of a cold engine without
   the tier, its registry hits and remote promotions at least 5 and a
   prefix hit, the paged-decode kernel running on the promoted pages; a
   ``ChaosStore`` with one truncated read counts a corrupt blob and a
   wedged one a promote timeout, both with the same tokens, the wedged
   turn's first token within the deadline plus a cold prefill; bf16 pages,
   then int8; spill seconds per page, the promote's probe, read + hash and
   upload seconds, wire bytes per page and turn 2's TTFT from the store
   against the cold one are printed with the card. Then, with the engines
   freed, two ``model_server`` workers with the tier on one shared root
   behind a port ``Router`` in this process: turn 1 through the router,
   the worker holding it SIGKILLed once five pages are in the store, turn 2
   through the router answered 200 by the survivor from the store
   (promoted bytes > 0, a prefix hit) with the tokens of the same path in
   process (one engine spills turn 1, a fresh one serves turn 2 from the
   store; a cold engine's and a copy-on-write engine's printed), 8 more
   requests with explicit statuses, at least 4 ok, the dead worker
   ejected, and the survivor's SIGTERM giving 143.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
one JSON object with every kernel's numbers.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
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
    excess = diff - (atol + rtol * ref.float().abs())
    if not torch.all(excess <= 0):
        at = int(excess.argmax())
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, tolerance {atol:g} + {rtol:g}*|ref|; "
             f"worst at flat index {at}: kernel "
             f"{float(out.flatten()[at].float()):.6g}, plain "
             f"{float(ref.flatten()[at].float()):.6g})")
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
    # ... and the training path's: fp32 norm weights, both backward passes.
    w32 = w.float()
    fused_norm.add_rmsnorm_fused(x, x, w32, eps=1e-5)
    _, _, rstd = fused_norm._norm_launch(x, None, w32, 1e-5, False)
    fused_norm.rmsnorm_bwd(x, w32, rstd, x)
    fused_norm.rmsnorm_bwd(x, w32, rstd, x, dy=x)
    fused_norm.swiglu_bwd(x, x, x, act="silu")
    th.join()
    if errors:
        raise errors[0]
    q = torch.zeros((1, 64, 32, 128), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((1, 64, 8, 128), dtype=torch.bfloat16, device="cuda")
    flash_attention(q, k, k)
    torch.cuda.synchronize()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, in parallel: "
          f"{', '.join(_build.SOURCES)}; triton: rms_fwd, rms_bwd, "
          "rms_dw_sum, swiglu_fwd, swiglu_bwd)",
          flush=True)
    report_ptxas(_build.PTXAS)


#: Kernels whose products run on wgmma with register accumulators.
WGMMA_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                 "flash_bwd_dq_kernel", "xent_fwd_kernel", "xent_dl_kernel",
                 "xent_dh_kernel", "xent_dw_kernel")


def report_ptxas(logs: dict) -> None:
    """Print each kernel's registers and spills from the ``ptxas -v`` logs
    of a build, and fail if a kernel of ``WGMMA_KERNELS`` spills or if
    ptxas serialized its wgmma instructions (notes C7515, C7520)."""
    for name, log in logs.items():
        for kernel, used, spills in ptxas_kernels(log):
            print(f"  ptxas {name}: {kernel}: {used}; {spills}", flush=True)
            # The warp-specialised kernels keep their accumulators in
            # registers: a spill undoes the design.
            if kernel.startswith(WGMMA_KERNELS) and \
                    "0 bytes spill stores, 0 bytes spill loads" not in spills:
                fail(f"{name}: {kernel} spills ({spills})")
        for ln in log.splitlines():
            # Warnings, and notes that wgmma instructions were serialized.
            if "warning" in ln.lower() or "performance" in ln.lower():
                print(f"  ptxas {name}: {ln.strip()}", flush=True)
                if "wgmma" in ln and any(k in ln for k in WGMMA_KERNELS):
                    fail(f"{name}: ptxas serialized the wgmma instructions "
                         f"of a warp-specialised kernel: {ln.strip()}")


def ptxas_kernels(log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers line, stack/spill line) of each entry function
    in a ``ptxas -v`` log, the kernel as ``name<D>`` from its mangled
    name."""
    out, kernel, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = kernel = m.group(1)
            i = 0
            while i < len(mangled):              # length-prefixed names
                k = re.match(r"\d+", mangled[i:])
                if not k:
                    i += 1
                    continue
                i += k.end()
                name = mangled[i:i + int(k.group())]
                i += len(name)
                if name.endswith("_kernel"):
                    arg = re.match(r"ILi(\d+)E", mangled[i:])
                    kernel = name + (f"<{arg.group(1)}>" if arg else "")
                    break
        elif "spill stores" in ln:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln and kernel:
            out.append((kernel, ln.split(":", 1)[-1].strip(), spills))
            kernel, spills = None, ""
    return out


def norm_fwd_rows() -> list[dict]:
    """Sites 1, 2 and 4: RMSNorm, residual + RMSNorm and SwiGLU at the
    decode (T = 8) and bucketed prefill (T = 2048) shapes; the prefill
    shape is the one recorded."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import fused_norm as fn

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
    return rows


def phase_kernels() -> list[dict]:
    rows = norm_fwd_rows()
    rows += flash_fwd_rows()
    rows += flash_bwd_rows()
    rows += norm_swiglu_bwd_rows()
    rows += xent_rows()
    rows += paged_kernel_rows()
    for r in rows:
        print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['library_ms']} bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return rows


def flash_fwd_rows() -> list[dict]:
    """Site 6: the flash forward at the prefill shape (B=1, H=32, KH=8,
    S=2048, D=128, causal; softcap too) against its plain version, timed
    on the kernel layout (``FlashAttentionFn.apply``, like the SDPA
    yardstick beside it); the three [B, S, H, D] -> [B, H, S, D] copies
    that ``flash_attention`` adds are timed on a line of their own."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.flash_attention import (
        FlashAttentionFn, flash_attention, flash_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 12)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    B, H, KH, S, Dh = 1, 32, 8, 2048, 128
    scale = Dh ** -0.5
    q, k, v = rnd(B, S, H, Dh), rnd(B, S, KH, Dh), rnd(B, S, KH, Dh)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    e_fl = 0.0
    for cap in (None, 30.0):
        o, lse = flash_attention(q, k, v, causal=True, logits_softcap=cap)
        ro, rl = flash_ref(qt, kt, vt, causal=True, sm_scale=scale,
                           softcap=cap, q_offset=0)
        e_o = within(o, ro.transpose(1, 2), f"flash o softcap={cap}")
        e_l = within(lse, rl, f"flash lse softcap={cap}", atol=LSE_ATOL,
                     rtol=0.0)
        e_fl = max(e_fl, e_o)
        print(f"kernel flash_fwd B={B} H={H} KH={KH} S={S} D={Dh} causal "
              f"softcap={cap}: max_abs_err o {e_o:.3e}, lse {e_l:.3e}",
              flush=True)
    copies = device_ms(lambda: [t.transpose(1, 2).contiguous()
                                for t in (q, k, v)])
    print(f"flash_attention layout copies (q, k, v to [B, H, S, D]): "
          f"{copies:.4f} ms, outside the kernel's time", flush=True)
    causal_pairs = S * (S + 1) / 2
    b_fl = bound(2 * (B * S * H * Dh * 2) + 2 * (B * S * KH * Dh * 2)
                 + B * H * S * 4, 4 * B * H * causal_pairs * Dh, BF16_FLOPS)
    return [dict(
        name="flash_fwd", route="cuda",
        source="kubeflow_tpu_torch/csrc/flash_fwd.cu",
        replaces="kubeflow_tpu/ops/flash_attention.py:156",
        max_abs_err=e_fl,
        ms=device_ms(lambda: FlashAttentionFn.apply(qt, kt, vt, True, scale,
                                                    None, 0)),
        plain_ms=device_ms(lambda: flash_ref(qt, kt, vt, causal=True,
                                             sm_scale=scale, softcap=None,
                                             q_offset=0),
                           iters=2, reps=3),
        bound_ms=b_fl[0], bound_by=b_fl[1],
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))]


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


def peaked_bwd_case(gen, B, H, KH, S, D):
    """Backward inputs whose attention has a sink, as trained heads do:
    a shared direction u (entries +-1) is added to every query and key 0
    is 1.25 u, so every query puts p >= 1/2 on key 0. Returns the inputs,
    the call's keywords and the share of query rows with p >= 1/2 there."""
    from kubeflow_tpu_torch.ops import flash_attention as FA

    (q, k, v, do, _, _), kw = bwd_case(gen, B, H, KH, S, S, D)
    u = torch.randint(0, 2, (D,), generator=gen, device="cuda").float() * 2 - 1
    q = (q.float() + u).to(torch.bfloat16)
    k = k.clone()
    k[:, :, 0] = (1.25 * u).to(torch.bfloat16)
    o, lse = FA.flash_ref(q, k, v, **kw)
    p0 = torch.exp(q.float() @ k[0, 0, 0].float() * kw["sm_scale"] - lse)
    return (q, k, v, do, lse, FA._delta(o, do)), kw, \
        float((p0 >= 0.5).float().mean())


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
    at the training shape (B=2, H=32, KH=8, S=2048, D=128, causal), each
    called twice on the same inputs for the same bits, then on inputs with
    an attention sink, where both are timed too. The plain version and the
    library call (the backward of SDPA) each compute dq, dk and dv
    together; their times stand in both rows."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator("cuda").manual_seed(SEED + 6)
    B, H, KH, S, D = 2, 32, 8, 2048, 128
    args, kw = bwd_case(gen, B, H, KH, S, S, D)
    errs, rel, (dq, dk, dv) = check_bwd(args, kw, "flash_bwd S=2048")
    dk2, dv2 = FA.flash_bwd_dkdv(*args, **kw)
    if not (torch.equal(dk2, dk) and torch.equal(dv2, dv)):
        fail("flash_bwd_dkdv: two calls on the same inputs differ (the GQA "
             "sum must not depend on timing)")
    if not torch.equal(FA.flash_bwd_dq(*args, **kw), dq):
        fail("flash_bwd_dq: two calls on the same inputs differ (the kv sum "
             "must not depend on timing)")
    print("kernels flash_bwd_dkdv and flash_bwd_dq: a second call is "
          "bit-identical", flush=True)
    print(f"kernel flash_bwd B={B} H={H} KH={KH} S={S} D={D} causal: "
          f"max_abs_err dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv "
          f"{errs['dv']:.3e}, worst rel L2 {rel:.3e} (tolerance "
          f"{BWD_REL_L2:g})", flush=True)
    if not rel <= BWD_REL_L2:
        fail(f"flash backward kernels: rel L2 {rel:.3e} > {BWD_REL_L2:g}")
    # The dK/dV kernel recomputes, from exact scores, the p >= 1/4 that lie
    # near a bf16 midpoint; attention with a sink has a p >= 1/4 in every
    # query row. Its cost: the kernel against a build without the
    # recompute, on those inputs and on the random ones.
    pk_args, _, share = peaked_bwd_case(gen, B, H, KH, S, D)
    if share < 0.99:
        fail(f"peaked backward inputs: only {share:.3f} of the query rows "
             "put p >= 1/2 on key 0")
    pk_errs, pk_rel, _ = check_bwd(pk_args, kw, "flash_bwd S=2048 peaked")
    if not pk_rel <= BWD_REL_L2:
        fail(f"flash backward kernels, peaked: rel L2 {pk_rel:.3e} > "
             f"{BWD_REL_L2:g}")
    no_exact = ("FLASH_DKDV_EXACT_P=0",)
    times = {(data, variant): device_ms(
                 (lambda a=a: FA.flash_bwd_dkdv(*a, **kw)) if variant == "with"
                 else (lambda a=a: FA._launch_bwd("dkdv", *a, **kw,
                                                  defines=no_exact)))
             for data, a in (("peaked", pk_args), ("random", args))
             for variant in ("with", "without")}
    print(f"kernel flash_bwd_dkdv peaked (p >= 1/2 on key 0 in "
          f"{share:.4f} of the query rows): max_abs_err "
          f"{max(pk_errs.values()):.3e}, rel L2 {pk_rel:.3e}; ms with the "
          f"exact-score recompute {times['peaked', 'with']:.4f}, without "
          f"{times['peaked', 'without']:.4f}; random inputs: with "
          f"{times['random', 'with']:.4f}, without "
          f"{times['random', 'without']:.4f}", flush=True)
    dq_ms = {data: device_ms(lambda a=a: FA.flash_bwd_dq(*a, **kw))
             for data, a in (("peaked", pk_args), ("random", args))}
    print(f"kernel flash_bwd_dq: max_abs_err peaked {pk_errs['dq']:.3e}; ms "
          f"peaked {dq_ms['peaked']:.4f}, random {dq_ms['random']:.4f}",
          flush=True)
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
    for name, n_products, out_bytes, ms, site, err in (
            ("flash_bwd_dkdv", 4, 2 * B * KH * S * D * 2,
             times["random", "with"], 331, max(errs["dk"], errs["dv"])),
            ("flash_bwd_dq", 3, B * H * S * D * 2, dq_ms["random"], 372,
             errs["dq"])):
        b = bound(in_bytes + out_bytes, n_products * product, BF16_FLOPS)
        rows.append(dict(
            name=name, route="cuda",
            source="kubeflow_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"kubeflow_tpu/ops/flash_attention.py:{site}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=library_ms))
    return rows


def event_ms(fn, iters: int = 3) -> float:
    """Device time of one ``fn()`` call between CUDA events, after one warm
    call: for work a CUDA graph cannot capture (autograd's own backward)
    or whose temporaries are too large to keep for a graph's replays."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def grad_ms(make, inputs, cotangent) -> float:
    """Device time of the backward alone of ``make(*inputs)`` for
    ``cotangent`` (the library yardstick of a backward kernel)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = make(*leaves)
    return event_ms(lambda: torch.autograd.grad(out, leaves, cotangent,
                                                retain_graph=True), iters=10)


def clocks_during(fn, seconds: float = 0.8) -> tuple[float, float]:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    while ``fn()`` runs back to back for about ``seconds``: the card lowers
    its clock under load near its power limit, by how much depending on the
    operands' bits."""
    samples: list[tuple[float, float]] = []
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=60).stdout.strip().splitlines()
            except (OSError, subprocess.SubprocessError):
                return
            try:
                clk, watts = (float(x) for x in out[0].split(","))
            except (IndexError, ValueError):
                continue
            samples.append((clk, watts))

    fn()
    torch.cuda.synchronize()
    th = threading.Thread(target=sample, name="nvidia-smi")
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or (len(samples) < 3
                                                  and th.is_alive()):
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > 10 * seconds:
            break
    stop.set()
    th.join()
    if not samples:
        return math.nan, math.nan
    return (sorted(c for c, _ in samples)[len(samples) // 2],
            sorted(w for _, w in samples)[len(samples) // 2])


def argmax_agrees(got: torch.Tensor, want: torch.Tensor, logits, name: str):
    """``correct`` from the kernel against the plain version's: a row may
    differ only where the plain logits' two largest values lie within 1e-4
    of each other (fp32 sums in another order may break such a near-tie
    either way). Returns the number of rows that differ."""
    diff = (got != want).nonzero().flatten()
    if diff.numel():
        top = logits[diff].topk(2, dim=-1).values
        if torch.any(top[:, 0] - top[:, 1] > 1e-4 * top[:, 0].abs().clamp_min(1)):
            fail(f"{name}: correct differs from the plain version on a row "
                 "whose maximum is not a near-tie")
    return int(diff.numel())


def norm_swiglu_bwd_rows() -> list[dict]:
    """Sites 3 and 5 at the training shapes: the RMSNorm backward (T = B·S
    = 4096 rows of D = 4096, bf16 activations, the fp32 weight and its fp32
    dw, as the trainer holds them) and the SwiGLU backward (M = 14336)."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator("cuda").manual_seed(SEED + 8)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    T, D, M, eps = 4096, 4096, 14336, 1e-5
    x, dh = rnd(T, D), rnd(T, D)
    w = 1.0 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
    _, _, rstd = fn._norm_launch(x, None, w, eps, False)
    e_rms, timed = 0.0, {}
    # Without and with the residual cotangent dy (the residual norm ln2,
    # 4 of the 9 launches of a training step): each held against the
    # plain version, called twice for the same bits, timed whole and per
    # kernel (the row pass and the dw column sum).
    for label, kw in (("", {}), (" dy", {"dy": rnd(T, D)})):
        dx, dw = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
        rdx, rdw = fn.rmsnorm_bwd_ref(x, w, rstd, dh, **kw)
        e_dx = within(dx, rdx, f"rmsnorm_bwd{label} dx")
        e_dw = within(dw, rdw, f"rmsnorm_bwd{label} dw")
        e_rms = max(e_rms, e_dx, e_dw)
        dx2, dw2 = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
        if not (torch.equal(dx2, dx) and torch.equal(dw2, dw)):
            fail(f"rmsnorm_bwd{label}: two calls on the same inputs differ")
        reads = (4 if kw else 3) * T * D * 2
        b = bound(reads + 2 * D * 4 + T * 4, (9 if kw else 8) * T * D,
                  FP32_FLOPS)
        ms = device_ms(lambda kw=kw: fn.rmsnorm_bwd(x, w, rstd, dh, **kw))
        parts = kernel_parts(lambda kw=kw: fn.rmsnorm_bwd(x, w, rstd, dh,
                                                          **kw))
        print(f"kernel rmsnorm_bwd{label} T={T} D={D}: max_abs_err dx "
              f"{e_dx:.3e}, dw {e_dw:.3e}; a second call is bit-identical; "
              f"ms {ms:.6f}, bound_ms {b[0]:.6f} ({b[1]}), "
              f"{b[0] / ms:.1%} of it; per kernel (profiler): "
              + ", ".join(f"{k} {v:.6f} ms x{n:g}"
                          for k, v, n in parts), flush=True)
        timed[label] = (ms, b)
        del dx, dw, rdx, rdw, dx2, dw2
    ms, b_rms = timed[""]
    rows = [dict(
        name="rmsnorm_bwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:146", max_abs_err=e_rms,
        ms=ms, plain_ms=event_ms(lambda: fn.rmsnorm_bwd_ref(x, w, rstd, dh)),
        bound_ms=b_rms[0], bound_by=b_rms[1],
        # The library call takes the weight in x's dtype: its fused path
        # refuses an fp32 weight beside bf16 x.
        library_ms=grad_ms(lambda x, w: F.rms_norm(x, (D,), w, eps),
                           (x, w.to(x.dtype)), dh))]
    del x, dh
    g, u, do = rnd(T, M), rnd(T, M), rnd(T, M)
    e_sw = 0.0
    for act in ("silu", "gelu"):
        dg, du = fn.swiglu_bwd(g, u, do, act=act)
        rdg, rdu = fn.swiglu_bwd_ref(g, u, do, act=act)
        e = max(within(dg, rdg, f"swiglu_bwd {act} dg"),
                within(du, rdu, f"swiglu_bwd {act} du"))
        e_sw = max(e_sw, e)
        print(f"kernel swiglu_bwd {act} T={T} M={M}: max_abs_err {e:.3e}",
              flush=True)
    b_sw = bound(5 * T * M * 2, 10 * T * M, FP32_FLOPS)
    rows.append(dict(
        name="swiglu_bwd", route="triton",
        source="kubeflow_tpu_torch/ops/fused_norm.py",
        replaces="kubeflow_tpu/ops/fused_norm.py:301", max_abs_err=e_sw,
        ms=device_ms(lambda: fn.swiglu_bwd(g, u, do, act="silu")),
        plain_ms=event_ms(lambda: fn.swiglu_bwd_ref(g, u, do, act="silu")),
        bound_ms=b_sw[0], bound_by=b_sw[1],
        library_ms=grad_ms(lambda g, u: F.silu(g) * u, (g, u), do)))
    return rows


def xent_case(gen, T, D, V, *, softcap=None, ties=True):
    """Inputs of one fused-CE call: bf16 h [T, D] and W [D, V] (scale
    D^-1/2), int32 targets with 0 and V-1 in them, and an nll cotangent
    (1/T, zero on a few rows as a loss mask gives). With ``ties``, pairs of
    equal head columns are made the maxima of rows 2-5: columns 5 and 77
    (one 128-column tile), and two columns on either side of the first
    forward range boundary (or of a tile boundary when there is one range);
    rows 2 and 4 target the lower column, rows 3 and 5 the higher. Row 6
    targets V + 5, outside the vocab. Returns (h, W, t, g, expected correct
    {row: value})."""
    from kubeflow_tpu_torch.ops import fused_xent as fx

    h = torch.randn((T, D), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((D, V), generator=gen, device="cuda")
         * D ** -0.5).to(torch.bfloat16)
    t = torch.randint(0, V, (T,), generator=gen, device="cuda",
                      dtype=torch.int32)
    g = torch.full((T,), 1.0 / T, device="cuda")
    t[0] = 0
    if T > 1:
        t[1] = V - 1
    expect = {}
    if ties and T > 6:
        slots = fx.forward_slots(torch.device("cuda", 0))
        edge = fx._tiles_per_range(T, V, slots) * fx.TILE
        edge = edge if edge < V else fx.TILE
        for row, (a, b) in ((2, (5, 77)), (4, (edge - 3, edge + 5))):
            w[:, b] = w[:, a]
            h[row] = h[row + 1] = (8.0 * w[:, a].float()).to(torch.bfloat16)
            t[row], t[row + 1] = a, b
            expect[row], expect[row + 1] = 1.0, 0.0
        t[6] = V + 5
        expect[6] = 0.0
    if T > 9:
        g[7:10] = 0.0
    return h, w, t, g, expect


def check_xent(gen, T, D, V, *, softcap=None, name=None, keep=False):
    """The fused CE kernels against their plain versions on one case;
    returns ({"nll", "lse", "dh", "dw": max abs error}, the case when
    ``keep``). The cotangent 1/T makes d_hidden and d_head small (about
    1e-6 to 1e-3 at T = 4096), so their absolute floor is ATOL times the
    plain output's largest magnitude, and each whole output is also held
    to BWD_REL_L2: a zeroed or misplaced output fails both."""
    from kubeflow_tpu_torch.ops import fused_xent as fx

    name = name or f"fused_xent T={T} D={D} V={V} softcap={softcap}"
    h, w, t, g, expect = xent_case(gen, T, D, V, softcap=softcap)
    nll, lse, cor = fx.xent_fwd(h, w, t, softcap)
    dh, dw = fx.xent_bwd(h, w, t, lse, g, softcap)
    rn, rl, rc = fx.xent_fwd_ref(h, w, t, softcap)
    errs = {"nll": within(nll, rn, f"{name} nll"),
            "lse": within(lse, rl, f"{name} lse", atol=LSE_ATOL, rtol=0.0)}
    logits = fx._logits_ref(h, w, softcap)
    n_diff = argmax_agrees(cor, rc, logits, name)
    del logits
    for row, want in expect.items():
        if float(cor[row]) != want:
            fail(f"{name}: row {row} correct {float(cor[row])}, expected "
                 f"{want} (argmax ties go to the lowest index)")
    if T > 6 and float(nll[6]) != float(lse[6]):
        fail(f"{name}: an out-of-vocab target must give nll = lse")
    rdh, rdw = fx.xent_bwd_ref(h, w, t, rl, g, softcap)
    rels = {}
    for part, got, want in (("dh", dh, rdh), ("dw", dw, rdw)):
        scale = float(want.float().abs().max())
        errs[part] = within(got, want, f"{name} {part}", atol=ATOL * scale)
        rels[part] = rel_l2(got, want) if scale > 0 else 0.0
        if not rels[part] <= BWD_REL_L2:
            fail(f"{name} {part}: rel L2 {rels[part]:.3e} > {BWD_REL_L2:g}")
        # The bound must tell a wrong output from this one: zeros, and the
        # output shifted by one column.
        for bad in (torch.zeros_like(got), got.roll(1, -1)):
            if scale > 0 and rel_l2(bad, want) <= BWD_REL_L2:
                fail(f"{name} {part}: the rel L2 bound does not reject a "
                     "zeroed or shifted output")
    if T > 9 and torch.count_nonzero(dh[7:10]):
        fail(f"{name}: rows with a zero loss mask have a nonzero dh")
    print(f"{name}: max_abs_err nll {errs['nll']:.3e}, lse "
          f"{errs['lse']:.3e}, dh {errs['dh']:.3e}, dw {errs['dw']:.3e}; "
          f"rel L2 dh {rels['dh']:.3e}, dw {rels['dw']:.3e} (tolerance "
          f"{BWD_REL_L2:g}); "
          f"correct differs on {n_diff} near-tie rows"
          + ("; ties, targets 0 / V-1 / out of vocab and masked rows hold"
             if expect else ""), flush=True)
    del rdh, rdw
    return errs, ((h, w, t, g, lse) if keep else None)


def xent_bwd_parts(h, w, t, lse, g, calls: int = 2) -> dict:
    """Device ms per ``xent_bwd`` call of each of its kernels (dl
    recompute, d_hidden, d_head), from a profile of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.ops import fused_xent as fx

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fx.xent_bwd(h, w, t, lse, g)
        torch.cuda.synchronize()
    _, kernels = _kernel_times(prof)
    part = {k: sum(ms for key, ms, _ in kernels
                   if f"xent_{k}_kernel" in key) / calls
            for k in ("dl", "dh", "dw")}
    if not all(part.values()):
        fail(f"the CE backward's profile lacks one of its kernels: {part}")
    return part


def xent_repeat(h, w, t, g, name: str) -> None:
    """A second ``xent_fwd`` and ``xent_bwd`` on the same inputs must give
    the same bits: no atomics, fixed orders of every sum."""
    from kubeflow_tpu_torch.ops import fused_xent as fx

    outs = []
    for _ in range(2):
        nll, lse, cor = fx.xent_fwd(h, w, t)
        outs.append((nll, lse, cor, *fx.xent_bwd(h, w, t, lse, g)))
    for part, a, b in zip(("nll", "lse", "correct", "dh", "dw"), *outs):
        if not torch.equal(a, b):
            fail(f"{name}: a second call gave other bits in {part}")
    print(f"{name}: a second xent_fwd and xent_bwd gave the same bits (nll, "
          "lse, correct, dh, dw)", flush=True)


def xent_rows() -> list[dict]:
    """Sites 9-11 at the training shape (T = 2 x 2048 tokens, D = 4096,
    V = 128256). The backward launches, per vocab chunk, the dl recompute
    and then the d_hidden and d_head products from it; a profile of it
    splits its device time: row 10 is the recompute and d_hidden (2
    passes over the logits), row 11 the d_head product (1 pass), and the
    two bounds add up to the backward's 3. No one PyTorch call fuses the
    projection with the CE, so rows 9 and 10 have no library_ms. Row 11's
    is cuBLAS on the same work: ``torch.matmul(h.t(), dl_c)`` ([D, vc]
    bf16 out) for each vocab chunk at its width, the chunks' products in
    one timed call, on each chunk's dl from the plain recompute (the
    values the kernel writes to its scratch, up to the rounding of exp).
    The port's own
    ``_chunked_ce`` (forward and backward, cuBLAS products, the path with
    fused kernels off) is timed beside them, and so is cuBLAS's product
    h W alone (``torch.matmul``, one pass, [T, V] bf16 out) as a yardstick
    of the card's GEMM rate. Then the same calls twice must give the same
    bits, and the forward and backward are timed on sink inputs, where
    every logit of a row is equal and every tile's maximum a tie (h = 0,
    and W with all columns equal), beside the random ones, after a check
    of each against the plain version (correct is then exactly
    target == 0); cuBLAS's product is timed on them too, and the SM clock
    is read under the forward, as the card's own speed on such operands."""
    import dataclasses

    from kubeflow_tpu_torch.models import decoder as dec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.ops import fused_xent as fx

    gen = torch.Generator("cuda").manual_seed(SEED + 9)
    T, D, V = 4096, 4096, 128256
    errs, (h, w, t, g, lse) = check_xent(gen, T, D, V, keep=True)
    unit = 2.0 * T * D * V                   # one pass over the logits
    io = T * D * 2 + D * V * 2 + T * 4       # h, W, targets
    fwd_ms = device_ms(lambda: fx.xent_fwd(h, w, t), iters=2, reps=2)
    plain_fwd = event_ms(lambda: fx.xent_fwd_ref(h, w, t), iters=2)
    plain_bwd = event_ms(lambda: fx.xent_bwd_ref(h, w, t, lse, g), iters=2)
    both_ms = device_ms(lambda: fx.xent_bwd(h, w, t, lse, g), iters=2,
                        reps=2)
    part = xent_bwd_parts(h, w, t, lse, g)
    rows = []
    b = bound(io + 3 * T * 4, unit, BF16_FLOPS)
    rows.append(dict(
        name="fused_xent_fwd", route="cuda",
        source="kubeflow_tpu_torch/csrc/fused_xent.cu",
        replaces="kubeflow_tpu/ops/fused_xent.py:149",
        max_abs_err=max(errs["nll"], errs["lse"]), ms=fwd_ms,
        plain_ms=plain_fwd, bound_ms=b[0], bound_by=b[1], library_ms=None))
    ht, dls = h.t(), []
    for c0 in range(0, V, fx.VOCAB_CHUNK):
        logits = fx._logits_ref(h, w[:, c0:c0 + fx.VOCAB_CHUNK], None)
        dls.append(fx._dlogits_ref(logits, t - c0, lse, g, None).to(
            torch.bfloat16))
        del logits
    dw_cublas = event_ms(lambda: [torch.matmul(ht, d) for d in dls], iters=5)
    del dls
    torch.cuda.empty_cache()
    # Row 10 reads h, W, targets, lse and g and writes dh; row 11 reads h
    # and the recompute's dl and writes dW.
    for name, site, ms, nbytes, passes, err, library_ms in (
            ("fused_xent_bwd_dh", 245, part["dl"] + part["dh"],
             io + 2 * T * 4 + T * D * 2, 2, errs["dh"], None),
            ("fused_xent_bwd_dw", 262, part["dw"],
             T * D * 2 + T * V * 2 + D * V * 2, 1, errs["dw"], dw_cublas)):
        b = bound(nbytes, passes * unit, BF16_FLOPS)
        rows.append(dict(
            name=name, route="cuda",
            source="kubeflow_tpu_torch/csrc/fused_xent.cu",
            replaces=f"kubeflow_tpu/ops/fused_xent.py:{site}",
            max_abs_err=err, ms=ms, plain_ms=plain_bwd, bound_ms=b[0],
            bound_by=b[1], library_ms=library_ms))
    b_both = bound(io + 2 * T * 4 + T * D * 2 + D * V * 2, 3 * unit,
                   BF16_FLOPS)
    # The chunked CE of the fused-off path at the same shape: forward and
    # backward to hidden and head, 4 chunks of 512 positions.
    cfg = dataclasses.replace(preset("llama3-8b"), loss_chunk_size=512)
    hb = h.reshape(2, 2048, D).detach().clone().requires_grad_(True)
    wb = w.detach().clone().requires_grad_(True)
    tb = t.long().reshape(2, 2048).clamp(0, V - 1)

    def chunked():
        nll, _ = dec._chunked_ce(hb, wb, tb, cfg)
        torch.autograd.grad(nll.sum() / T, (hb, wb))

    chunked_ms = event_ms(chunked)
    del hb, wb, tb
    torch.cuda.empty_cache()
    cublas_ms = event_ms(lambda: torch.matmul(h, w), iters=5)
    torch.cuda.empty_cache()
    tflops = lambda passes, ms: passes * unit / (ms * 1e-3) / 1e12  # noqa: E731
    print(f"kernel fused_xent T={T} D={D} V={V}: forward {fwd_ms:.3f} ms "
          f"({tflops(1, fwd_ms):.0f} TFLOP/s; bound "
          f"{rows[0]['bound_ms']:.3f}); backward {both_ms:.3f} ms (bound "
          f"{b_both[0]:.3f}, 3 passes), profiled as dl recompute "
          f"{part['dl']:.3f} ({tflops(1, part['dl']):.0f} TFLOP/s) + "
          f"d_hidden {part['dh']:.3f} ({tflops(1, part['dh']):.0f}) + "
          f"d_head {part['dw']:.3f} ({tflops(1, part['dw']):.0f}) ms, "
          f"cuBLAS h^T dl over the same {len(range(0, V, fx.VOCAB_CHUNK))} "
          f"chunks {dw_cublas:.3f} ms ({tflops(1, dw_cublas):.0f} TFLOP/s); "
          f"forward + backward {fwd_ms + both_ms:.3f} ms against the chunked "
          f"CE's {chunked_ms:.3f} ms (cuBLAS, 4 passes); yardstick: "
          f"torch.matmul(h, W) [{T}, {D}] x [{D}, {V}] {cublas_ms:.3f} ms "
          f"({tflops(1, cublas_ms):.0f} TFLOP/s, one pass, [T, V] bf16 "
          "written)", flush=True)
    xent_repeat(h, w, t, g, f"fused_xent T={T} D={D} V={V}")
    clk = clocks_during(lambda: fx.xent_fwd(h, w, t))
    # Sink inputs, every row one long tie: h = 0 (every logit 0, zero
    # operands), and W with every column equal (random nonzero operands).
    sinks = (("h = 0", torch.zeros_like(h), w),
             ("equal columns", h, w[:, :1].expand(D, V).contiguous()))
    for label, hs, ws in sinks:
        nll0, lse0, cor0 = fx.xent_fwd(hs, ws, t)
        rn, rl, rc = fx.xent_fwd_ref(hs, ws, t)
        within(nll0, rn, f"sink ({label}) fused_xent nll")
        within(lse0, rl, f"sink ({label}) fused_xent lse", atol=LSE_ATOL,
               rtol=0.0)
        if not torch.equal(cor0, (t == 0).float()) or \
                not torch.equal(cor0, rc):
            fail(f"sink ({label}) fused_xent: with every logit of a row "
                 "equal, correct must be exactly target == 0 (the lowest "
                 "index)")
        rdh, rdw = fx.xent_bwd_ref(hs, ws, t, rl, g)
        dh0, dw0 = fx.xent_bwd(hs, ws, t, lse0, g)
        for grad, got, want in (("dh", dh0, rdh), ("dw", dw0, rdw)):
            within(got, want, f"sink ({label}) fused_xent {grad}",
                   atol=ATOL * float(want.float().abs().max()))
        del rn, rl, rc, rdh, rdw, dh0, dw0
        sink_fwd = device_ms(lambda: fx.xent_fwd(hs, ws, t), iters=2, reps=2)
        sink = xent_bwd_parts(hs, ws, t, lse0, g)
        sink_mm = event_ms(lambda: torch.matmul(hs, ws), iters=5)
        sink_clk = clocks_during(lambda: fx.xent_fwd(hs, ws, t))
        print(f"kernel fused_xent sink inputs ({label}): forward "
              f"{sink_fwd:.3f} ms ({sink_fwd / fwd_ms:.3f}x random), dl "
              f"recompute + d_hidden {sink['dl'] + sink['dh']:.3f} ms "
              f"({(sink['dl'] + sink['dh']) / (part['dl'] + part['dh']):.3f}"
              f"x random), d_head {sink['dw']:.3f} ms; cuBLAS's h W "
              f"{sink_mm:.3f} ms ({sink_mm / cublas_ms:.3f}x random); SM "
              f"clock under the forward {sink_clk[0]:.0f} MHz at "
              f"{sink_clk[1]:.0f} W (random: {clk[0]:.0f} MHz at "
              f"{clk[1]:.0f} W); the results match the plain version",
              flush=True)
        del hs, ws
        torch.cuda.empty_cache()
    return rows


def phase_xent_edges(gen=None) -> None:
    """The fused CE away from the training shape, against its plain
    version: T in {1, 300, 4096}, V in {1000, 128256, 256000, 20000}
    (ragged last tile, one tile, many ranges, the backward's last chunk of
    13568 columns at 128256, and at 20000 a last chunk of 3616, ragged in
    its tiles and in the d_hidden product's K, after one whole chunk),
    D in {1160, 2048, 4096} (1160, a multiple of 8 and not of 64: ragged K
    in the forward and dl, ragged N in d_hidden, and in d_head ragged A
    boxes, one wholly past D, and ragged output rows), softcap 30, with
    argmax ties inside a tile and across a range boundary, targets 0, V-1
    and out of vocab, and masked rows (exactly zero dh)."""
    gen = gen or torch.Generator("cuda").manual_seed(SEED + 10)
    for T, D, V, cap in ((1, 2048, 1000, None), (300, 4096, 1000, 30.0),
                         (4096, 2048, 1000, None), (1, 4096, 128256, 30.0),
                         (300, 2048, 128256, None), (300, 4096, 256000, 30.0),
                         (4096, 2048, 256000, None), (300, 2048, 20000, None),
                         (300, 1160, 20000, None)):
        check_xent(gen, T, D, V, softcap=cap,
                   name=f"edge fused_xent T={T} D={D} V={V} softcap={cap}")
        torch.cuda.empty_cache()


def phase_train_edges() -> None:
    """The training kernels away from the training shape, each against its
    plain version: the fused CE (``phase_xent_edges``); the RMSNorm
    backward at D in {2048, 3072, 4096} (3072: a masked row block), T in
    {1, 300}, with and without (1 + w) and the residual cotangent; the
    SwiGLU backward (silu, gelu) at odd M."""
    gen = torch.Generator("cuda").manual_seed(SEED + 10)
    phase_xent_edges(gen)
    phase_norm_bwd_edges(gen)


def phase_norm_bwd_edges(gen=None) -> None:
    """The RMSNorm backward at D in {2048, 3072, 4096} (3072: a masked row
    block), T in {1, 300}, with and without (1 + w) and the residual
    cotangent, each called twice for the same bits; the SwiGLU backward
    (silu, gelu) at odd M."""
    from kubeflow_tpu_torch.ops import fused_norm as fn

    gen = gen or torch.Generator("cuda").manual_seed(SEED + 10)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    for T in (1, 300):
        for D, plus_one, residual in ((2048, False, True), (3072, True, False),
                                      (4096, True, True)):
            x, dh, dy = rnd(T, D), rnd(T, D), rnd(T, D)
            w = 0.1 * torch.randn((D,), generator=gen, device="cuda")
            _, _, rstd = fn._norm_launch(x, None, w, 1e-6, plus_one)
            kw = dict(plus_one=plus_one, dy=dy if residual else None)
            dx, dw = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
            rdx, rdw = fn.rmsnorm_bwd_ref(x, w, rstd, dh, **kw)
            name = (f"edge rmsnorm_bwd T={T} D={D} plus_one={plus_one} "
                    f"residual={residual}")
            e = max(within(dx, rdx, name + " dx"), within(dw, rdw, name + " dw"))
            dx2, dw2 = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
            if not (torch.equal(dx2, dx) and torch.equal(dw2, dw)):
                fail(f"{name}: two calls on the same inputs differ")
            print(f"{name}: max_abs_err {e:.3e}; a second call is "
                  "bit-identical", flush=True)
        for M in (1001, 14336):
            g, u, do = rnd(T, M), rnd(T, M), rnd(T, M)
            for act in ("silu", "gelu"):
                dg, du = fn.swiglu_bwd(g, u, do, act=act)
                rdg, rdu = fn.swiglu_bwd_ref(g, u, do, act=act)
                name = f"edge swiglu_bwd {act} T={T} M={M}"
                e = max(within(dg, rdg, name + " dg"),
                        within(du, rdu, name + " du"))
                print(f"{name}: max_abs_err {e:.3e}", flush=True)
    explain_bwd_edges(gen)


def explain_bwd_edges(gen) -> None:
    """The explainer's backward shapes: a 37-token prompt (a multiple of no
    tile) through serving weights — bf16 and needing no gradient, so the
    RMSNorm backward neither stores dw partials nor sums them. Each kernel
    against its plain version, timed (the kernel table's T = 37 note); then
    the norm and SwiGLU ``autograd.Function``s with only the activation
    requiring grad must give the weight no gradient and the plain
    backward's dx."""
    from kubeflow_tpu_torch.ops import fused_norm as fn

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    T, D, M, eps = 37, 4096, 14336, 1e-5
    w = (1.0 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(
        torch.bfloat16)
    x, dh, dy = rnd(T, D), rnd(T, D), rnd(T, D)
    _, _, rstd = fn._norm_launch(x, None, w, eps, False)
    for label, kw in (("", {}), (" dy", {"dy": dy})):
        name = f"edge rmsnorm_bwd{label} T={T} D={D} bf16 w"
        dx, dw = fn.rmsnorm_bwd(x, w, rstd, dh, **kw)
        rdx, rdw = fn.rmsnorm_bwd_ref(x, w, rstd, dh, **kw)
        e = max(within(dx, rdx, name + " dx"), within(dw, rdw, name + " dw"))
        dx2, none = fn.rmsnorm_bwd(x, w, rstd, dh, need_dw=False, **kw)
        if none is not None or not torch.equal(dx2, dx):
            fail(f"{name}: need_dw=False changed dx or returned a dw")
        b = bound((4 if kw else 3) * T * D * 2 + D * 2 + T * 4,
                  (9 if kw else 8) * T * D, FP32_FLOPS)
        ms = device_ms(lambda kw=kw: fn.rmsnorm_bwd(x, w, rstd, dh,
                                                    need_dw=False, **kw))
        print(f"{name}: max_abs_err {e:.3e}; without dw (the explainer's "
              f"call) bit-identical dx, ms {ms:.6f}, bound_ms {b[0]:.6f} "
              f"({b[1]})", flush=True)
    g, u, do = rnd(T, M), rnd(T, M), rnd(T, M)
    dg, du = fn.swiglu_bwd(g, u, do, act="silu")
    rdg, rdu = fn.swiglu_bwd_ref(g, u, do, act="silu")
    name = f"edge swiglu_bwd silu T={T} M={M}"
    e = max(within(dg, rdg, name + " dg"), within(du, rdu, name + " du"))
    b = bound(5 * T * M * 2, 10 * T * M, FP32_FLOPS)
    ms = device_ms(lambda: fn.swiglu_bwd(g, u, do, act="silu"))
    print(f"{name}: max_abs_err {e:.3e}, ms {ms:.6f}, bound_ms {b[0]:.6f} "
          f"({b[1]})", flush=True)
    # The autograd Functions, weight without grad: dx of the plain backward.
    xg = x[None].clone().requires_grad_(True)
    (got,) = torch.autograd.grad(fn.rmsnorm_fused(xg, w, eps=eps), xg,
                                 dh[None])
    within(got[0], fn.rmsnorm_bwd_ref(x, w, rstd, dh)[0],
           "edge rmsnorm_fused autograd, bf16 w without grad")
    yg, hg = fn.add_rmsnorm_fused(xg, dy[None], w, eps=eps)
    (got,) = torch.autograd.grad((yg, hg), xg, (dy[None], dh[None]))
    _, _, rstd_y = fn._norm_launch(x + dy, None, w, eps, False)
    within(got[0], fn.rmsnorm_bwd_ref(x + dy, w, rstd_y, dh, dy=dy)[0],
           "edge add_rmsnorm_fused autograd, bf16 w without grad")
    gg = g.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(fn.swiglu_fused(gg, u), gg, do)
    within(got, rdg, "edge swiglu_fused autograd, up without grad")
    if w.grad is not None or u.grad is not None:
        fail("edge autograd: a tensor that needs no gradient got one")
    print(f"edge norm and SwiGLU autograd.Functions T={T}: weights without "
          "grad get none; dx equals the plain backward's", flush=True)


def phase_memory_probe() -> None:
    """The fused CE never holds [T, V] logits: the peak allocation of its
    forward and backward at T = 4096, D = 4096, V = 128256 (bf16), less
    what was allocated before the call and the two gradients it must
    return, stays within one eighth of one fp32 [T, V] tensor. The plain
    path's peak is printed beside it."""
    from kubeflow_tpu_torch.ops import fused_xent as fx

    gen = torch.Generator("cuda").manual_seed(SEED + 11)
    T, D, V = 4096, 4096, 128256
    h, w, t, g, _ = xent_case(gen, T, D, V, ties=False)
    mask = (g > 0).float()
    limit = T * V * 4 / 8
    peaks = {}
    for name, fn in (("fused", fx.fused_cross_entropy),
                     ("plain", fx.reference_cross_entropy)):
        hl = h.detach().clone().requires_grad_(True)
        wl = w.detach().clone().requires_grad_(True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        nll, _ = fn(hl, wl, t)
        loss = (nll * mask).sum() / mask.sum()
        grads = torch.autograd.grad(loss, (hl, wl))
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - before
                       - sum(x.numel() * x.element_size() for x in grads))
        del hl, wl, nll, loss, grads
        torch.cuda.empty_cache()
    print(f"memory probe T={T} D={D} V={V}: fused CE forward+backward peak "
          f"beyond its inputs and gradients {peaks['fused'] / 1e6:.1f} MB "
          f"(limit {limit / 1e6:.1f} MB, one eighth of an fp32 [T, V]); the "
          f"plain path's {peaks['plain'] / 1e6:.1f} MB", flush=True)
    if not peaks["fused"] <= limit:
        fail("the fused CE allocated more than its memory bound")


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


def tickets_zero(name: str) -> None:
    """Fail unless every ticket counter the paged-decode kernel has been
    given is back at zero (the last split block of each (slot, kv head)
    resets its own; one left nonzero breaks every later call there)."""
    from kubeflow_tpu_torch.ops import paged_attention as PA

    torch.cuda.synchronize()
    for held in PA._TICKETS.values():
        for buf in held:
            if torch.count_nonzero(buf):
                fail(f"{name}: the paged-decode kernel left a ticket "
                     "counter nonzero")


def paged_checked(fn, case, name: str) -> torch.Tensor:
    """``paged_call`` of the kernel's wrapper, then the counters checked."""
    out = paged_call(fn, case)
    tickets_zero(name)
    return out


def paged_one_launch(case, name: str) -> None:
    """One call of the wrapper runs exactly one CUDA kernel, the split
    kernel, which merges its own splits (the profiler's count)."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.ops import paged_attention as PA

    paged_call(PA.paged_decode_attention, case)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        paged_call(PA.paged_decode_attention, case)
        torch.cuda.synchronize()
    _, kernels = _kernel_times(prof)
    if [("paged_decode_split_kernel" in k, n) for k, _, n in kernels] != \
            [(True, 1)]:
        fail(f"{name}: one call ran {kernels}, not the split kernel once")
    tickets_zero(name)


def paged_graph_repeat(case, name: str, calls: int = 20,
                       replays: int = 50) -> None:
    """``calls`` calls of ``case`` captured in one CUDA graph and replayed
    ``replays`` times: every call of every replay must give the bits of an
    eager call (a counter left nonzero, or a block that merges before its
    peers' partials land, shows here), and the counters end at zero."""
    from kubeflow_tpu_torch.ops import paged_attention as PA

    want = paged_checked(PA.paged_decode_attention, case, name)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            paged_call(PA.paged_decode_attention, case)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [paged_call(PA.paged_decode_attention, case)
                for _ in range(calls)]
    differ = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(replays):
        graph.replay()
        differ += (torch.stack(outs) != want).sum()
    if int(differ):
        fail(f"{name}: {int(differ)} output elements over {replays} graph "
             f"replays of {calls} calls differ from an eager call")
    tickets_zero(name)
    print(f"kernel {name}: {calls} calls in a CUDA graph, replayed "
          f"{replays} times, give an eager call's bits every time; the "
          "counters end at zero", flush=True)


def paged_kernel_rows() -> list[dict]:
    """Site 12: the paged-decode kernel (the split kernel, whose last block
    of each (slot, kv head) merges the splits) against its plain version at
    the serving shape (8 slots, 32 query over 8 kv heads of 128, pages of
    128, 16 page slots), bf16 and int8 pools, with the split count the
    wrapper chose: one kernel launch per call, the ticket counters zero
    after every call, and a CUDA graph of the recorded case whose replays
    repeat its bits. The recorded time is at length 2047, whose ~67 MB of
    bf16 K/V exceeds the 50 MB L2; length 1024 (~34 MB, served from L2 on
    back-to-back replays) is printed beside it, and so are 1 and 32 slots
    at length 2047 and the recorded case at named split counts."""
    from kubeflow_tpu_torch.ops import paged_attention as PA

    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    H, KH, D, page, mpp = 32, 8, 128, 128, 16
    rows, recorded = [], {}
    for name, quant in (("paged_decode", False), ("paged_decode_int8", True)):
        slots = PA._slots(0, D, page, H // KH, quant)
        print(f"kernel {name}: the card holds {slots} split blocks at once",
              flush=True)
        err, timed = 0.0, None
        for B, length in ((8, 2047), (8, 1024), (1, 2047), (32, 2047)):
            case = paged_case(gen, B, H, KH, D, page, [length] * B,
                              quant=quant, mpp=mpp)
            label = f"{name} B={B} length {length}"
            e = within(paged_checked(PA.paged_decode_attention, case, label),
                       paged_call(PA.paged_decode_ref, case), label)
            err = max(err, e)
            ms = device_ms(lambda: paged_call(PA.paged_decode_attention,
                                              case))
            tickets_zero(label)
            b = bound(paged_bytes(case), paged_flops(case), FP32_FLOPS)
            print(f"kernel {name} B={B} H={H} KH={KH} D={D} page={page} "
                  f"length={length} splits "
                  f"{PA._num_splits(B, KH, mpp, slots)}: max_abs_err "
                  f"{e:.3e}, ms {ms:.4f}, bound_ms {b[0]:.4f} ({b[1]}, "
                  f"{paged_bytes(case) / 1e6:.1f} MB"
                  f"{', fits the 50 MB L2' if length == 1024 else ''})",
                  flush=True)
            if timed is None:
                timed = (case, ms, b)
        case, ms, b = timed
        recorded[name] = case
        paged_one_launch(case, name)
        paged_graph_repeat(case, name)
        rows.append(dict(
            name=name, route="cuda",
            source="kubeflow_tpu_torch/csrc/paged_decode.cu",
            replaces="kubeflow_tpu/ops/paged_attention.py:169",
            max_abs_err=err, ms=ms,
            plain_ms=device_ms(lambda: paged_call(PA.paged_decode_ref, case),
                               iters=2, reps=3),
            bound_ms=b[0], bound_by=b[1],
            # No single PyTorch call attends over a page table.
            library_ms=None))
    # The recorded bf16 case at named split counts (the wrapper's choice
    # from shapes is printed above).
    case = recorded["paged_decode"]
    sweep = {n: device_ms(lambda n=n: PA._launch(
        case["q"], case["pool_k"], case["pool_v"], case["table"],
        case["lengths"], None, None, D ** -0.5, splits=n))
        for n in (1, 2, 4, 8, 16)}
    tickets_zero("paged_decode split sweep")
    print("kernel paged_decode B=8 length=2047 ms by split count: "
          + ", ".join(f"{n}: {ms:.4f}" for n, ms in sweep.items()),
          flush=True)
    return rows


def phase_edges() -> None:
    """The kernels away from the serving shapes, each against its plain
    version: ragged edges (lengths not a multiple of a tile or block), a
    static q_offset, head_dim 64, a non-causal Sq != Skv block with softcap
    and an explicit scale, one query row, the (1 + w) norm, odd widths and
    strided inputs."""
    phase_norm_edges()
    phase_flash_edges()
    phase_flash_bwd_edges()
    phase_train_edges()
    phase_paged_edges()


def phase_norm_edges() -> None:
    """The norm and SwiGLU forwards away from the serving shapes: T of 1, 5
    and 37, D of 1000 and 3072 (masked row blocks), the (1 + w) norm, and
    SwiGLU/GeGLU on strided [6, 1000] views."""
    from kubeflow_tpu_torch.ops import fused_norm as fn

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


def phase_flash_edges() -> None:
    """The flash forward against its plain version away from the prefill
    shape: ragged lengths around its 128-row tiles (127, 128, 129, 255,
    257), a static q_offset, a causal diagonal that crosses a q tile off
    its boundary (Sq = 200, Skv = 328, q_offset = 128), head_dim 64 with
    one and four query heads per kv head, eight query heads per kv head at
    B = 3, a non-causal Sq != Skv block with softcap and an explicit scale,
    one query row, and rows that see no key (q_offset -5, -70, and -200,
    where a whole 128-row tile sees none): they average V over every key
    and their lse is NEG_INF, as in the plain version."""
    from kubeflow_tpu_torch.ops.flash_attention import (
        flash_attention, flash_ref,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    # (B, H, KH, Sq, Skv, D, causal, q_offset, softcap, sm_scale)
    cases = ((2, 4, 2, 200, 200, 128, True, 0, None, None),
             (1, 8, 8, 130, 200, 64, True, 70, None, None),
             (1, 8, 2, 77, 333, 128, False, 0, 20.0, 0.1),
             (3, 32, 8, 1, 517, 128, True, 516, None, None),
             *((1, 8, 2, n, n, 128, True, 0, None, None)
               for n in (127, 128, 129, 255, 257)),
             (1, 8, 2, 200, 328, 128, True, 128, None, None),
             (2, 8, 8, 257, 257, 64, True, 0, 30.0, None),
             (1, 8, 2, 129, 129, 64, True, 0, None, None),
             (3, 32, 4, 129, 129, 128, True, 0, None, None),
             (1, 8, 2, 200, 200, 128, True, -5, None, None),
             (1, 4, 2, 200, 200, 128, True, -70, None, None),
             (1, 4, 2, 300, 300, 64, True, -200, None, None))
    for B, H, KH, Sq, Skv, Dh, causal, off, cap, scale in cases:
        q, k, v =rnd(B, Sq, H, Dh), rnd(B, Skv, KH, Dh), rnd(B, Skv, KH, Dh)
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


# Edge cases of the flash backward, in the order phase_flash_bwd_edges draws
# their inputs from one generator: (B, H, KH, Sq, Skv, D, causal, q_offset,
# softcap).
FLASH_BWD_EDGES = (
    (1, 8, 2, 1, 1, 128, True, 0, None),
    (1, 8, 2, 63, 63, 128, True, 0, None),
    (1, 8, 2, 64, 64, 64, True, 0, None),
    (1, 8, 8, 65, 65, 128, True, 0, None),
    (1, 8, 1, 1000, 1000, 128, True, 0, 30.0),
    (1, 4, 2, 2047, 2047, 128, True, 0, None),
    (2, 4, 2, 300, 1000, 64, True, 700, None),
    (1, 4, 2, 200, 200, 128, False, 0, 20.0),
    (1, 4, 2, 128, 128, 64, True, -5, None),
    *((1, 8, 2, n, n, 128, True, 0, None)
      for n in (127, 128, 129, 255, 257)),
    (1, 8, 2, 200, 328, 128, True, 128, None),
    (1, 8, 8, 257, 257, 64, True, 0, None),
    (3, 32, 4, 129, 129, 128, True, 0, None),
    (1, 4, 2, 200, 200, 128, True, -70, None))


def phase_flash_bwd_edges() -> None:
    """The two backward kernels against the plain backward away from the
    training shape: S = 1, 63, 64, 65, 127, 128, 129, 255, 257, 1000 and
    2047 (ragged tiles of both kernels), a causal diagonal that crosses a
    kv tile off its boundary (Sq = 200, Skv = 328, q_offset = 128),
    head_dim 64, one, four and eight query heads per kv head (eight at
    B = 3), softcap, Sq < Skv at q_offset = Skv - Sq, a non-causal block,
    and rows that see no key (negative q_offset: lse is NEG_INF; their dq
    must be zero and their cotangents must not move dk or dv)."""
    from kubeflow_tpu_torch.ops import flash_attention as FA

    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    for B, H, KH, Sq, Skv, D, causal, off, cap in FLASH_BWD_EDGES:
        args, kw = bwd_case(gen, B, H, KH, Sq, Skv, D, causal=causal,
                            q_offset=off, softcap=cap)
        name = (f"flash_bwd B={B} H={H} KH={KH} Sq={Sq} Skv={Skv} D={D} "
                f"causal={causal} q_offset={off} softcap={cap}")
        errs, rel, (dq, dk, dv) = check_bwd(args, kw, name)
        note = ""
        if off < 0:
            if torch.count_nonzero(dq[:, :, :-off]):
                fail(f"{name}: rows that see no key have a nonzero dq")
            do = args[3].clone()
            do[:, :, :-off] = 100.0
            dk2, dv2 = FA.flash_bwd_dkdv(*args[:3], do, *args[4:], **kw)
            if not (torch.equal(dk2, dk) and torch.equal(dv2, dv)):
                fail(f"{name}: the cotangents of rows that see no key move "
                     "dk or dv")
            note = "; rows with no key give zero dq and move no dk/dv"
        print(f"edge {name}: max_abs_err {max(errs.values()):.3e}, rel L2 "
              f"{rel:.3e}{note}", flush=True)


def phase_paged_edges() -> None:
    """The paged-decode kernel against its plain version away from the
    serving shape: length 0, lengths on and one short of page boundaries,
    unmapped table entries, a dead row (no mapped page: zeros), pages no
    table names poisoned with 999 (the output must not move), head_dim 64,
    one and eight query heads per kv head, pages of 16, and int8 pools
    whose scale planes carry outliers. The ticket counters must be zero
    after every call."""
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
        out = paged_checked(paged_decode_attention, case, name)
        e = within(out, paged_call(paged_decode_ref, case), name)
        if not torch.equal(paged_checked(paged_decode_attention, case, name),
                           out):
            fail(f"{name}: two calls on the same inputs differ")
        poison_spare_pages(case)
        if not torch.equal(paged_checked(paged_decode_attention, case, name),
                           out):
            fail(f"{name}: the output moved when unmapped pages changed")
        # A dead row: every table entry unmapped, so the output is zeros.
        case["table"][0] = -1
        dead = paged_checked(paged_decode_attention, case, name)[0]
        if torch.count_nonzero(dead):
            fail(f"{name}: a row with no mapped page is not all zeros")
        print(f"edge {name}: max_abs_err {e:.3e}; a second call is "
              "bit-identical; poisoned unmapped pages change nothing; a dead "
              "row is zeros; the counters are zero after every call", flush=True)
    phase_paged_split_edges()


def poison_spare_pages(case) -> None:
    """Fill the pages no table entry names (the spare pages and the sink)
    with 999 (99 in int8 pages, which hold at most 127; their scales with
    999): a kernel that reads none of them gives the same bits."""
    named = case["table"][case["table"] >= 0].long().unique()
    spare = torch.ones(case["pool_k"].shape[0], dtype=torch.bool,
                       device="cuda")
    spare[named] = False
    poison = 99 if "pool_ks" in case else 999
    for plane in ("pool_k", "pool_v"):
        case[plane][spare] = poison
    for plane in ("pool_ks", "pool_vs"):
        if plane in case:
            case[plane][spare] = 999.0


# Edge cases of the split over pages, each run at the split counts listed
# (the wrapper's own choice aside): (B, H, KH, D, page, mpp, lengths, int8,
# unmapped (slot, page slot), split counts).
PAGED_SPLIT_EDGES = (
    # Slots whose later splits all start past their length.
    (4, 32, 8, 128, 128, 16, [100, 700, 2047, 128], False, (),
     (1, 2, 3, 5, 16)),
    # With 3 splits of 4 page slots, slot 0's split 1 is all unmapped
    # between counted splits 0 and 2.
    (2, 8, 2, 128, 16, 12, [190, 100], False,
     ((0, 4), (0, 5), (0, 6), (0, 7)), (3, 4)),
    # mpp = 13 under split counts that do not divide it.
    (3, 16, 4, 64, 16, 13, [207, 150, 0], False, ((1, 6),),
     (2, 3, 4, 5, 6, 13)),
    (3, 16, 4, 128, 16, 13, [207, 150, 0], True, ((1, 6),), (4, 5)),
)


def phase_paged_split_edges() -> None:
    """The split kernel, merging in its last block, against the plain
    version at split counts the caller names: every count must agree with
    ``paged_decode_ref``, repeat its bits on a second call, keep them when
    the pages no table names are poisoned, and leave the ticket counters
    zero after every call."""
    from kubeflow_tpu_torch.ops import paged_attention as PA

    gen = torch.Generator("cuda").manual_seed(SEED + 8)
    for (B, H, KH, D, page, mpp, lengths, quant, unmapped,
         counts) in PAGED_SPLIT_EDGES:
        case = paged_case(gen, B, H, KH, D, page, lengths, quant=quant,
                          mpp=mpp, unmapped=unmapped)
        name = (f"paged_decode split B={B} H={H} KH={KH} D={D} page={page} "
                f"mpp={mpp} lengths={lengths} int8={quant} "
                f"unmapped={list(unmapped)}")

        def run(n):
            out = PA._launch(case["q"], case["pool_k"], case["pool_v"],
                             case["table"], case["lengths"],
                             case.get("pool_ks"), case.get("pool_vs"),
                             D ** -0.5, splits=n)
            tickets_zero(f"{name} splits={n}")
            return out

        ref = paged_call(PA.paged_decode_ref, case)
        outs, err = {}, 0.0
        for n in counts:
            outs[n] = run(n)
            err = max(err, within(outs[n], ref, f"{name} splits={n}"))
            if not torch.equal(run(n), outs[n]):
                fail(f"{name} splits={n}: two calls on the same inputs "
                     "differ")
        poison_spare_pages(case)
        for n in counts:
            if not torch.equal(run(n), outs[n]):
                fail(f"{name} splits={n}: the output moved when unmapped "
                     "pages changed")
        print(f"edge {name}: splits {list(counts)} max_abs_err {err:.3e}; "
              "each bit-identical on a second call and with poisoned "
              "unmapped pages; the counters zero after every call",
              flush=True)


def _post(url: str, body: dict, timeout: float = 600.0,
          headers: dict | None = None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def text(n_tokens: int, salt: int) -> str:
    """A prompt of ``n_tokens`` tokens under the byte tokenizer (one token
    per byte plus BOS)."""
    return "".join(chr(97 + (i * 7 + salt) % 26) for i in range(n_tokens - 1))


def _series(url: str, name: str) -> float:
    """One series of a replica's ``/metrics`` (its single model's sample)."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
        for ln in resp.read().decode().splitlines():
            if ln.startswith(name + "{") or ln.startswith(name + " "):
                return float(ln.rsplit(" ", 1)[1])
    return 0.0


def _resident_pages(url: str) -> float:
    """``kftpu_engine_kv_pages_resident`` as ``/metrics`` shows it."""
    return _series(url, "kftpu_engine_kv_pages_resident")


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


#: The page pool every paged engine here runs (and the worker of phase (c)):
#: 8 slots of up to 2048 tokens over 64 pages of 128, chunks of 512, the
#: paged-decode kernel, the radix prefix index.
PAGED_SPEC = dict(paged=True, page_size=128, max_pages=64, max_batch_size=8,
                  max_seq_len=2048, chunked_prefill_tokens=512,
                  paged_attn_impl="pallas", weights_dtype="bfloat16")


def paged_engine(engine, **overrides):
    """A paged LLMEngine (``PAGED_SPEC``) over the contiguous engine's
    weights (shared, not copied)."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    spec = dict(PAGED_SPEC)
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
    tickets_zero("paged serve")


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


def kernel_parts(fn, calls: int = 20) -> list[tuple[str, float, float]]:
    """(kernel, device ms per call, launches per call) of every CUDA kernel
    that ``calls`` eager calls of ``fn`` run, from ``torch.profiler``
    (each kernel's own execution time, whatever the host's launch gaps)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    _, kernels = _kernel_times(prof)
    return [(key[:60], ms / calls, count / calls)
            for key, ms, count in kernels]


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


# -- the predictor replica: explain, loadgen, the worker, file:// ------------

# grad_x_input's per-token scores, kernel path vs plain path over 32 bf16
# layers: relative L2, the prefill's band.
EXPLAIN_REL_L2 = PREFILL_REL_L2
#: The offered traffic of every loadgen phase (``standard_matrix``).
LOADGEN = dict(num_requests=24, rate_rps=4.0, prompt_len=512, max_new=64,
               seed=SEED)
#: The worker's greedy prompts: a 128-bucket prompt, a 512-bucket one and a
#: chunked one.
WORKER_PROMPTS = ((60, 51), (300, 52), (700, 53))


class TokenIdText:
    """The byte tokenizer's encoding, with every token id decoded as decimal
    text ("17 4093 "): a served random-weight model's greedy ids come back
    over HTTP exactly, where the byte tokenizer drops every id past 258.
    The worker of phase (c) loads it as ``chip_smoke:TokenIdText``."""

    PAD, BOS, EOS, OFFSET = 0, 1, 2, 3
    bos_id, eos_id, vocab_size = BOS, EOS, 256 + OFFSET

    def encode(self, text: str) -> list[int]:
        return [self.BOS] + [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: list[int]) -> str:
        return "".join(f"{i} " for i in ids)


def phase_explain(engine) -> None:
    """(a) The explainer hop on the 32-layer serving engine, in process, on
    a 37-token prompt: ``grad_x_input`` through the kernels (the norm and
    SwiGLU backward on serving weights that need no gradient; each kernel's
    count set to 0 just before and read just after: 2L + 1 RMSNorm backward
    calls — ln1, the residual ln2, the final norm — and L SwiGLU backward
    calls) against the plain path (``fused_kernels="off"``) on the same
    weights: the same target token, scores within ``EXPLAIN_REL_L2``. Then
    ``leave_one_out``: finite scores and the same target."""
    import dataclasses

    from kubeflow_tpu_torch.ops import fused_norm as fn
    from kubeflow_tpu_torch.serve.explain import grad_x_input, leave_one_out

    cfg = engine.cfg
    gen = torch.Generator().manual_seed(SEED + 20)
    prompt = torch.randint(3, 259, (37,), generator=gen).tolist()
    wrappers = {"rmsnorm_fwd": fn.rmsnorm_fused,
                "add_rmsnorm_fwd": fn.add_rmsnorm_fused,
                "swiglu_fwd": fn.swiglu_fused,
                "rmsnorm_bwd": fn.rmsnorm_bwd, "swiglu_bwd": fn.swiglu_bwd}
    grad_x_input(prompt, params=engine.params, cfg=cfg)       # warm
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    kern = grad_x_input(prompt, params=engine.params, cfg=cfg)
    t_kern = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    plain = grad_x_input(prompt, params=engine.params,
                         cfg=dataclasses.replace(cfg, fused_kernels="off"))
    a = torch.tensor(kern["scores"], dtype=torch.float64)
    b = torch.tensor(plain["scores"], dtype=torch.float64)
    rel = float((a - b).norm() / b.norm())
    t0 = time.perf_counter()
    loo = leave_one_out(prompt, params=engine.params, cfg=cfg)
    t_loo = time.perf_counter() - t0
    print(f"explain grad_x_input ({len(prompt)} tokens, {cfg.n_layers} "
          f"layers): {t_kern:.3f} s, target {kern['target_token']} (plain "
          f"path {plain['target_token']}), scores rel L2 {rel:.3e} "
          f"(tolerance {EXPLAIN_REL_L2:g}), kernels " + json.dumps(launches),
          flush=True)
    print(f"explain leave_one_out ([{len(prompt)}, {len(prompt)}] forward): "
          f"{t_loo:.3f} s, target {loo['target_token']}, scores "
          f"[{min(loo['scores']):.4f}, {max(loo['scores']):.4f}]", flush=True)
    if kern["target_token"] != plain["target_token"]:
        fail("explain: the kernel path's target token differs from the "
             "plain path's")
    if not rel <= EXPLAIN_REL_L2:
        fail("explain: grad_x_input through the kernels disagrees with the "
             "plain path")
    want = {"rmsnorm_bwd": 2 * cfg.n_layers + 1, "swiglu_bwd": cfg.n_layers}
    for name, count in launches.items():
        if count != want.get(name, count) or count <= 0:
            fail(f"explain: {name} launched {count} times, expected "
                 f"{want.get(name, '> 0')}")
    if len(loo["scores"]) != len(prompt) or not all(
            math.isfinite(v) for v in loo["scores"] + kern["scores"]):
        fail("explain: non-finite or missing scores")
    if loo["target_token"] != kern["target_token"]:
        fail("explain: leave_one_out's target differs from grad_x_input's")


def report_line(label: str, rep: dict, card: str) -> None:
    """Print one loadgen report's client-side numbers on a line, with the
    card."""
    ttft, tpot, lag = rep["ttft_ms"], rep["tpot_ms"], rep["schedule_lag_ms"]
    line = (f"loadgen {label}: {rep['requests']} requests "
            f"{json.dumps(rep['by_status'])}, TTFT p50 {ttft.get('p50')} p95 "
            f"{ttft.get('p95')} ms, TPOT p50 {tpot.get('p50')} p95 "
            f"{tpot.get('p95')} ms, {rep['req_s']} req/s, "
            f"{rep['tokens_per_sec']} tokens/s, generator lag p50 "
            f"{lag.get('p50')} p95 {lag.get('p95')} ms; {card}")
    print(line, flush=True)


def check_statuses(label: str, rep: dict) -> None:
    bad = {k: v for k, v in rep["by_status"].items() if k not in ("ok", "shed")}
    if bad or not rep["by_status"].get("ok"):
        fail(f"loadgen {label}: statuses {rep['by_status']}")


def phase_loadgen_engine(engine, card: str) -> None:
    """(b) The open-loop load generator in process (``EngineTarget``) on the
    contiguous serving engine: ``bursty_qos`` of ``standard_matrix``
    (``LOADGEN``). Every request ok or shed; the report's TTFT, TPOT,
    req/s, tokens/s and the generator's own lag."""
    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.serve.server import serving_metrics_registry

    sc = next(x for x in loadgen.standard_matrix(**LOADGEN)
              if x.name == "bursty_qos")
    engine.start()
    try:
        run = loadgen.run_scenario(
            loadgen.EngineTarget(engine), sc, vocab_size=engine.cfg.vocab_size,
            max_prompt_len=engine.max_len - sc.output_len.value - 1)
        text = serving_metrics_registry([("llama3-8b", engine)]).render()
    finally:
        engine.stop()
    rep = loadgen.build_report(run, metrics_text=text)
    report_line("bursty_qos (EngineTarget, contiguous cache)", rep, card)
    print(f"loadgen bursty_qos phases {json.dumps(rep['phases'])}, per class "
          f"{json.dumps(rep.get('qos', {}))}", flush=True)
    check_statuses("bursty_qos", rep)


def worker_reference(engine) -> list[list[int]]:
    """The greedy tokens phase (c)'s worker must give its three prompts: a
    paged engine of the worker's spec (``PAGED_SPEC``) over the serving
    weights, which ``random://`` with the same seed reproduces in the
    worker; each prompt alone, as the worker gets them."""
    from kubeflow_tpu_torch.serve.engine import SamplingParams

    tok = TokenIdText()
    peng = paged_engine(engine)
    out = []
    for n, salt in WORKER_PROMPTS:
        got = peng.generate(tok.encode(text(n, salt)), SamplingParams(
            max_new_tokens=16, temperature=0.0, stop_token=tok.eos_id))
        out.append([t for t in got if t != tok.eos_id])
    del peng
    torch.cuda.empty_cache()
    return out


def _get(url: str, timeout: float = 30.0) -> tuple[int, str]:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


#: The workers' model and platform: Llama-3-8B in bf16 on the card.
WORKER_MODEL = {"preset": "llama3-8b", "overrides": {"param_dtype": "bfloat16"}}
WORKER_PLATFORM = "gpu"


def spawn_worker(batching: dict, label: str):
    """Start ``python -m kubeflow_tpu_torch.runtime.worker_main`` serving
    Llama-3-8B from ``random://`` (bf16, the serving seed) with
    ``batching``, the ``strip`` transformer, the ``grad_x_input`` explainer
    and the ``chip_smoke:TokenIdText`` tokenizer, on a free port of this
    host. Returns (process, url, log file)."""
    import tempfile

    from kubeflow_tpu_torch.runtime.bootstrap import WorkerEnv, free_port

    repo = Path(__file__).resolve().parent
    port = free_port()
    conf = {"model": WORKER_MODEL,
            "storage_uri": "random://",
            "batching": batching, "port": port, "service": "llama",
            "explainer": {"handler": "grad_x_input"},
            "transformer": {"handler": "strip"},
            "tokenizer": "chip_smoke:TokenIdText"}
    wenv = WorkerEnv(coordinator_address="127.0.0.1:0", num_processes=1,
                     process_id=0, job=f"default/llama-{label}",
                     replica_index=0, entrypoint="model_server", config=conf,
                     parallelism={}, platform=WORKER_PLATFORM)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KFTPU_")}
    env.update(wenv.to_env())
    env["PYTHONPATH"] = str(repo)
    log = tempfile.NamedTemporaryFile(prefix=f"chip_smoke_{label}_",
                                      suffix=".log", delete=False)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker_main"],
        cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log


def wait_ready(proc, url: str, label: str, t0: float) -> float:
    """Seconds from ``t0`` until the worker answers its readiness probe."""
    while True:
        if proc.poll() is not None:
            fail(f"{label} exited {proc.returncode} before it was ready")
        try:
            if _get(url + "/v2/health/ready", timeout=2.0)[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > 300:
            fail(f"{label} not ready after 300 s")
        time.sleep(0.5)


def sigterm_worker(proc, url: str, label: str) -> None:
    """SIGTERM must end the worker with 143 within 30 s and close its
    port."""
    import signal

    proc.send_signal(signal.SIGTERM)
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        fail(f"{label}: still alive 30 s after SIGTERM")
    print(f"{label}: SIGTERM -> exit code {rc} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if rc != 143:
        fail(f"{label}: SIGTERM gave exit code {rc}, not 143")
    try:
        _get(url + "/v2/health/ready", timeout=2.0)
        fail(f"{label}: its port still answers after SIGTERM")
    except OSError:
        pass


def reap_worker(proc, log, label: str, ok: bool) -> None:
    """Kill a worker still running (a failed phase) and drop its log,
    printing its tail when the phase failed."""
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)
    log.close()
    if not ok:
        print(f"{label} log (tail):\n" + Path(log.name).read_text()[-4000:],
              file=sys.stderr, flush=True)
    os.unlink(log.name)


#: ``mixed_interference``'s offered traffic: LOADGEN with 384-token prompts,
#: so its batch class's 4 x 384 = 1536-token prompts fit ``PAGED_SPEC``'s
#: max_seq_len of 2048 (at 512 they would be 2048 and every one refused).
MIXED = dict(LOADGEN, prompt_len=384)


def run_mixed(target, label: str, card: str, metrics_url: str) -> tuple:
    """``mixed_interference`` through ``target``; prints its report line
    and per-class split. Returns (run, report)."""
    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.obs import stats

    sc = next(x for x in loadgen.standard_matrix(**MIXED)
              if x.name == "mixed_interference")
    run = loadgen.run_scenario(target, sc, vocab_size=128256,
                               max_prompt_len=PAGED_SPEC["max_seq_len"]
                               - sc.output_len.value - 1)
    rep = loadgen.build_report(run, metrics_text=_get(metrics_url
                                                      + "/metrics")[1])
    # The report splits TTFT by class; TPOT per class from the outcomes.
    for cls, entry in rep.get("qos", {}).items():
        entry["tpot_ms"] = stats.quantiles_ms(
            [t for o in run.outcomes if o.ok and o.qos == cls
             for t in [o.tpot_s()] if t is not None], qs=(0.5, 0.95))
    report_line(f"mixed_interference ({label})", rep, card)
    print(f"loadgen mixed_interference ({label}) per class "
          f"{json.dumps(rep.get('qos', {}))}", flush=True)
    return run, rep


def phase_worker(want: list[list[int]], card: str) -> dict:
    """(c) The predictor replica as a process: ``python -m
    kubeflow_tpu_torch.runtime.worker_main`` with ``KFTPU_ENTRYPOINT=
    model_server``, ``KFTPU_PLATFORM=gpu``, Llama-3-8B from ``random://``
    (bf16, the serving seed) on the page pool, the ``strip`` transformer and
    the ``grad_x_input`` explainer. Its kernels must already be built (no
    ``nvcc`` in the worker). Greedy completions must give ``want`` token for
    token; chat (streamed and not) and ``:explain`` must answer; then
    ``uniform`` and ``shared_prefix`` through ``ServerTarget``, with
    ``/metrics`` showing resident pages under load and none after it, and
    prefix hits in ``shared_prefix``. SIGTERM must end it with 143 and
    close its port. Before the SIGTERM, ``mixed_interference`` (``MIXED``)
    runs against it, the unified side of (e)'s comparison; its report is
    returned."""
    from kubeflow_tpu_torch import loadgen

    t0 = time.perf_counter()
    proc, url, log = spawn_worker(PAGED_SPEC, "worker")
    ok = False
    try:
        t_ready = wait_ready(proc, url, "worker", t0)
        logged = Path(log.name).read_text()
        m = re.search(r"CUDA kernels ready in ([0-9.]+) s \(compiled here: "
                      r"([^)]*)\)", logged)
        if m is None:
            fail("worker: no kernel build line in its log")
        print(f"worker: ready in {t_ready:.1f} s; kernels ready in "
              f"{m.group(1)} s, compiled in the worker: {m.group(2)}",
              flush=True)
        if m.group(2) != "none":
            fail("worker: ran nvcc for kernels the checkout already built")

        tok = TokenIdText()
        for (n, salt), ref in zip(WORKER_PROMPTS, want):
            status, raw = _post(url + "/v1/completions",
                                {"prompt": text(n, salt), "max_tokens": 16})
            out = json.loads(raw)
            got = [int(t) for t in out["choices"][0]["text"].split()]
            print(f"worker greedy {n} tokens: {got} "
                  f"({'identical to' if got == ref else 'differs from'} the "
                  f"in-process paged engine's)", flush=True)
            if got != ref:
                fail(f"worker: greedy tokens {got} differ from the "
                     f"in-process engine's {ref}")
        msgs = {"messages": [{"role": "user", "content": text(40, 54)}],
                "max_tokens": 8}
        out = json.loads(_post(url + "/v1/chat/completions", msgs)[1])
        if out["object"] != "chat.completion" or not \
                out["choices"][0]["message"]["content"].split():
            fail(f"worker: chat completion {out}")
        raw = _post(url + "/v1/chat/completions",
                    {**msgs, "stream": True})[1].decode()
        chunks = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
        if not chunks or chunks[-1] != "[DONE]" or not all(
                "delta" in json.loads(c)["choices"][0] for c in chunks[:-1]):
            fail("worker: malformed chat stream")
        prompt = text(40, 55)
        (exp,) = json.loads(_post(url + "/v1/models/llama:explain",
                                  {"instances": [prompt]})[1])["explanations"]
        if len(exp["scores"]) != len(tok.encode(prompt)) or not all(
                math.isfinite(v) for v in exp["scores"]):
            fail(f"worker: explain gave {len(exp['scores'])} scores for "
                 f"{len(tok.encode(prompt))} tokens")
        print(f"worker: chat {len(chunks) - 1} streamed chunks; explain "
              f"{exp['method']} {len(exp['scores'])} scores, target "
              f"{exp['target_token']}", flush=True)

        hits = {}
        for name in ("uniform", "shared_prefix"):
            sc = next(x for x in loadgen.standard_matrix(**LOADGEN)
                      if x.name == name)
            resident, done = [0.0], threading.Event()

            def watch():
                while not done.is_set():
                    try:
                        resident[0] = max(resident[0], _resident_pages(url))
                    except OSError:
                        pass
                    done.wait(0.05)

            th = threading.Thread(target=watch)
            th.start()
            try:
                run = loadgen.run_scenario(
                    loadgen.ServerTarget(url, model="llama"), sc,
                    vocab_size=128256, max_prompt_len=1024)
            finally:
                done.set()
                th.join(timeout=60)
            metrics = _get(url + "/metrics")[1]
            rep = loadgen.build_report(run, metrics_text=metrics)
            report_line(f"{name} (ServerTarget, worker, page pool)", rep,
                        card)
            check_statuses(name, rep)
            hits[name] = rep["engine"].get("kv_tier", {}).get(
                "prefix_hits", 0)
            # No leak: once the last stream ended, the scheduler releases
            # its pages within a step or two.
            for _ in range(50):
                after = _resident_pages(url)
                if after == 0:
                    break
                time.sleep(0.1)
            print(f"worker {name}: most pages resident on /metrics "
                  f"{resident[0]:.0f}, after the run {after:.0f}, prefix "
                  f"hits so far {hits[name]}", flush=True)
            if resident[0] <= 0:
                fail(f"worker {name}: /metrics never showed a resident page")
            if after:
                fail(f"worker {name}: pages still resident after the run")
        if hits["shared_prefix"] - hits["uniform"] <= 0:
            fail("worker shared_prefix: the prefix index never hit")
        _, mixed = run_mixed(loadgen.ServerTarget(url, model="llama"),
                             "ServerTarget, unified worker", card, url)
        check_statuses("mixed_interference (unified worker)", mixed)
        sigterm_worker(proc, url, "worker")
        ok = True
    finally:
        reap_worker(proc, log, "worker", ok)
    return mixed


# -- (e) disaggregated prefill/decode and the host KV tier -------------------

#: The host tier's engine: PAGED_SPEC with 64 host pages and a short demote
#: time; ``multi_turn`` thinks longer than that between turns.
HOST_TIER = dict(host_kv_pages=64, kv_demote_after_s=0.5)
#: The host tier's conversation: turn 1's prompt, and the new text of turn
#: 2 ((tokens, salt) of ``text``).
HOST_TURNS = ((700, 71), (61, 72))
MULTI_TURN_THINK_S = 10.0


def _drive(eng, req, timeout: float = 600.0):
    """Step an engine without its thread until ``req`` finishes."""
    t0 = time.perf_counter()
    while not req.done.is_set():
        eng.step()
        if time.perf_counter() - t0 > timeout:
            fail(f"request {req.id} did not finish in {timeout} s")
    return req


def _settle(eng, label: str) -> None:
    """Step until no page is referenced and no hold or round is left; then
    every page of the pool must be free or cached, with no owner left."""
    t0 = time.perf_counter()
    while eng.kv_pages_in_use() or eng._handoff_holds or eng._rounds:
        eng.step()
        if time.perf_counter() - t0 > 60:
            fail(f"{label}: pages still referenced after 60 s")
    alloc = eng._allocator
    leaks = alloc.leak_report_by_owner()
    if leaks or alloc.available() != alloc.num_pages:
        fail(f"{label}: {alloc.num_pages - alloc.available()} pages neither "
             f"free nor cached, owners {leaks}")


def _timed(obj, name: str, sink: list, when=lambda: True) -> None:
    """Wrap ``obj.name`` to append its synchronized seconds to ``sink``
    (only for calls where ``when()`` holds)."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        if not when():
            return fn(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, run)


def _planes(eng, pages: list[int]) -> dict:
    names = ("k", "v", "ks", "vs") if eng.kv_quant else ("k", "v")
    return {n: eng.cache[n][:, pages].clone() for n in names}


def handoff_in_process(uni) -> int:
    """(e) 1. A prefill-role and a decode-role engine over ``uni``'s weights
    (``PAGED_SPEC``): the worker's three greedy prompts exported, sent
    through ``to_wire`` → ``from_wire`` and adopted must give the unified
    paged engine's tokens exactly, bf16 pages and int8 pages; after the
    acks no page is referenced on either engine. Returns the paged-decode
    launches on adopted pages."""
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention
    from kubeflow_tpu_torch.serve.engine import SamplingParams
    from kubeflow_tpu_torch.serve.handoff import HandoffPayload

    tok = TokenIdText()
    params = SamplingParams(max_new_tokens=16, temperature=0.0,
                            stop_token=tok.eos_id)
    total = 0
    for quant in (None, "int8"):
        label = "handoff in process " + ("int8" if quant else "bf16")
        ref = uni if quant is None else paged_engine(uni,
                                                     kv_cache_dtype=quant)
        pre = paged_engine(uni, role="prefill", kv_cache_dtype=quant)
        dec = paged_engine(uni, role="decode", kv_cache_dtype=quant)
        t_export, t_adopt = [], []
        _timed(pre, "_export_handoff", t_export)
        _timed(pre, "_flush_handoffs", t_export,
               when=lambda: bool(pre._pending_exports))
        _timed(dec, "_adopt_handoff", t_adopt)
        launches = 0
        for n, salt in WORKER_PROMPTS:
            prompt = tok.encode(text(n, salt))
            want = ref.generate(prompt, params)
            t_export.clear()
            t_adopt.clear()
            p_req = _drive(pre, pre.submit(prompt, params))
            if p_req.finish_reason != "handoff":
                fail(f"{label}: the prefill engine finished "
                     f"{p_req.finish_reason!r}, not with a handoff")
            wire = p_req.handoff.to_wire()
            payload = HandoffPayload.from_wire(wire)
            paged_decode_attention.launches = 0
            d_req = _drive(dec, dec.submit_handoff(payload))
            launches += paged_decode_attention.launches
            got = [payload.first_token] + d_req.output_tokens
            pre.complete_handoff(p_req.id)
            print(f"{label}: {len(prompt)}-token prompt, wire "
                  f"{len(wire)} bytes ({payload.wire_bytes} of KV), export "
                  f"{sum(t_export) * 1e3:.2f} ms, adopt "
                  f"{sum(t_adopt) * 1e3:.2f} ms, {len(got)} tokens "
                  f"{'identical to' if got == want else 'differ from'} the "
                  f"unified paged engine's", flush=True)
            if got != want:
                fail(f"{label}: tokens {got} differ from {want}")
        _settle(pre, label + " (prefill engine)")
        _settle(dec, label + " (decode engine)")
        print(f"{label}: paged_decode launches on adopted pages {launches}; "
              f"no page referenced on either engine after the acks",
              flush=True)
        if launches <= 0:
            fail(f"{label}: the paged-decode kernel never ran on adopted "
                 "pages")
        total += launches
        del pre, dec, ref
        torch.cuda.empty_cache()
    return total


def host_tier_in_process(uni, card: str) -> int:
    """(e) 2. A paged engine with the host tier (``HOST_TIER``): turn 1,
    an idle gap past the demote time, turn 2. The pages' bytes before
    demotion and after promotion must be equal, bf16 and int8 pools with
    their scales, and turn 2's tokens must equal those of an engine
    without the tier (where the prefix hits on the device). Then
    ``multi_turn`` through ``EngineTarget`` on the bf16 engine, thinking
    ``MULTI_TURN_THINK_S`` between turns: no request errors, pages demote
    and promote, none stays referenced. Returns the paged-decode launches
    on promoted pages."""
    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention
    from kubeflow_tpu_torch.serve.engine import SamplingParams
    from kubeflow_tpu_torch.serve.kvtier import TIER_DEVICE
    from kubeflow_tpu_torch.serve.server import serving_metrics_registry

    tok = TokenIdText()
    params = SamplingParams(max_new_tokens=16, temperature=0.0,
                            stop_token=tok.eos_id)
    turn1 = tok.encode(text(*HOST_TURNS[0]))
    total = 0
    for quant in (None, "int8"):
        label = "host tier " + ("int8" if quant else "bf16")
        teng = paged_engine(uni, kv_cache_dtype=quant, **HOST_TIER)
        base = paged_engine(uni, kv_cache_dtype=quant)
        out1 = teng.generate(turn1, params)
        torch.cuda.synchronize()
        nodes = {p: teng._kvtier._by_page[p]
                 for p in teng._allocator.reclaimable_lru()}
        before = _planes(teng, list(nodes))
        # The index holds the engine's closures: time them there.
        fetched = []
        fetch = teng._kvtier._fetch_pages

        def timed_fetch(ids, fetch=fetch, fetched=fetched):
            fetched.append(time.perf_counter())
            return fetch(ids)

        teng._kvtier._fetch_pages = timed_fetch
        t0 = time.perf_counter()
        while teng.kv_pages_host() < len(nodes):
            teng.step()
            teng._kvtier.drain_migrations(60.0)
            if time.perf_counter() - t0 > 60:
                fail(f"{label}: {teng.kv_pages_host()} of {len(nodes)} "
                     "pages demoted after 60 s")
            time.sleep(0.02)
        t_demote = time.perf_counter() - fetched[0]
        turn2 = turn1 + out1 + tok.encode(text(*HOST_TURNS[1]))[1:]
        t_up = []
        _timed(teng._kvtier, "_upload_pages", t_up)
        paged_decode_attention.launches = 0
        out2 = teng.generate(turn2, params)
        launches = paged_decode_attention.launches
        after = {old: n.page for old, n in nodes.items()
                 if n.tier == TIER_DEVICE}
        now = _planes(teng, list(after.values()))
        idx = [list(nodes).index(old) for old in after]
        equal = bool(after) and all(torch.equal(now[n], t[:, idx])
                                    for n, t in before.items())
        base.generate(turn1, params)
        want2 = base.generate(turn2, params)
        stats = teng.kv_tier_stats()
        print(f"{label}: {len(nodes)} pages demoted ({stats['demote_wire_bytes']}"
              f" wire bytes) in {t_demote:.3f} s from the gather to the last "
              f"blob; {len(after)} promoted and {stats['cow_copies']} "
              f"copy-on-write tail from the host ({stats['promote_wire_bytes']}"
              f" wire bytes) in {sum(t_up):.4f} s; page bytes "
              f"{'equal' if equal else 'DIFFER'} after promotion "
              f"({', '.join(before)}); turn 2 tokens "
              f"{'identical to' if out2 == want2 else 'differ from'} the "
              f"engine without the tier; paged_decode launches on promoted "
              f"pages {launches}", flush=True)
        if not equal:
            fail(f"{label}: promoted page bytes differ from the demoted "
                 "ones")
        if out2 != want2:
            fail(f"{label}: turn 2 tokens {out2} differ from {want2}")
        if stats["pages_demoted"] <= 0 or stats["pages_promoted"] <= 0 \
                or launches <= 0:
            fail(f"{label}: demoted {stats['pages_demoted']}, promoted "
                 f"{stats['pages_promoted']}, decode launches {launches}")
        total += launches
        _settle(base, label + " (without the tier)")
        del base
        if quant is None:
            sc = next(x for x in loadgen.standard_matrix(
                **LOADGEN, multi_turn_think_s=MULTI_TURN_THINK_S)
                if x.name == "multi_turn")
            before_run = teng.kv_tier_stats()
            teng.start()
            try:
                run = loadgen.run_scenario(
                    loadgen.EngineTarget(teng), sc,
                    vocab_size=teng.cfg.vocab_size,
                    max_prompt_len=teng.max_len - sc.output_len.value - 1)
                metrics = serving_metrics_registry(
                    [("llama3-8b", teng)]).render()
                t0 = time.perf_counter()
                while teng.kv_pages_in_use() and \
                        time.perf_counter() - t0 < 30:
                    time.sleep(0.05)
            finally:
                teng.stop()
            rep = loadgen.build_report(run, metrics_text=metrics)
            report_line("multi_turn (EngineTarget, page pool, host tier)",
                        rep, card)
            st = teng.kv_tier_stats()
            moved = {k: st[k] - before_run[k]
                     for k in ("pages_demoted", "pages_promoted",
                               "demote_wire_bytes", "promote_wire_bytes",
                               "tokens_matched")}
            print(f"multi_turn host tier: {json.dumps(moved)}, pages on the "
                  f"host after the run {teng.kv_pages_host()}, resident "
                  f"{teng.kv_pages_in_use()}, phases "
                  f"{json.dumps(rep['phases'])}", flush=True)
            bad = {k: v for k, v in rep["by_status"].items()
                   if k not in ("ok", "shed")}
            if bad or not rep["by_status"].get("ok"):
                fail(f"multi_turn: statuses {rep['by_status']}")
            if moved["pages_demoted"] <= 0 or moved["pages_promoted"] <= 0:
                fail(f"multi_turn: no demotion or promotion: {moved}")
            if teng.kv_pages_in_use():
                fail("multi_turn: pages still referenced after the run")
        teng.stop()             # ends its migration thread, which holds it
        del teng
        torch.cuda.empty_cache()
    return total


def _decode_backend_target(url: str, decode_url: str):
    """A ``ServerTarget`` that stamps ``X-Kftpu-Decode-Backend`` on its
    requests, as the router would (the loadgen itself stays the JAX
    package's): while its requests are issued, ``http.client``'s connection
    class is a subclass that adds the header for the issuing thread only."""
    import http.client

    from kubeflow_tpu_torch import loadgen
    from kubeflow_tpu_torch.core.headers import DECODE_BACKEND_HEADER

    local = threading.local()
    base = http.client.HTTPConnection

    class Stamped(base):
        def request(self, method, url, body=None, headers=None, **kw):
            extra = getattr(local, "headers", None)
            headers = {**(headers or {}), **(extra or {})}
            return super().request(method, url, body, headers, **kw)

    class Target(loadgen.ServerTarget):
        def issue(self, sr, root, timeout_s, prompt=None):
            local.headers = {DECODE_BACKEND_HEADER: decode_url}
            try:
                return super().issue(sr, root, timeout_s, prompt=prompt)
            finally:
                local.headers = None

    return Target(url, model="llama"), Stamped, base


def phase_worker_pair(want: list[list[int]], unified: dict,
                      card: str) -> None:
    """(e) 3. A prefill-role and a decode-role worker process on the one
    card, each as (c)'s worker with its ``batching.role``: the three
    greedy prompts through the prefill worker (with the decode worker's URL
    in ``X-Kftpu-Decode-Backend``) must give ``want``; ``mixed_interference``
    (``MIXED``) through them must be all ok, with one export per request
    that had tokens to decode, one adoption per export, no failed or
    fallback handoff and no page resident after; its report sits beside
    the unified worker's from (c). Then the fallback: with the decode
    worker gone, a prompt still gives ``want[0]`` and the fallback counter
    reads 1. Both workers end with 143 on SIGTERM."""
    import http.client

    from kubeflow_tpu_torch.core.headers import DECODE_BACKEND_HEADER

    t0 = time.perf_counter()
    pre, pre_url, pre_log = spawn_worker(dict(PAGED_SPEC, role="prefill"),
                                         "prefill-worker")
    dec, dec_url, dec_log = spawn_worker(dict(PAGED_SPEC, role="decode"),
                                         "decode-worker")
    ok = False
    try:
        t_pre = wait_ready(pre, pre_url, "prefill worker", t0)
        t_dec = wait_ready(dec, dec_url, "decode worker", t0)
        print(f"worker pair: prefill ready in {t_pre:.1f} s, decode ready in "
              f"{t_dec:.1f} s", flush=True)
        hdr = {DECODE_BACKEND_HEADER: dec_url}
        for (n, salt), ref in zip(WORKER_PROMPTS, want):
            raw = _post(pre_url + "/v1/completions",
                        {"prompt": text(n, salt), "max_tokens": 16},
                        headers=hdr)[1]
            got = [int(t) for t in
                   json.loads(raw)["choices"][0]["text"].split()]
            print(f"worker pair greedy {n} tokens: "
                  f"{'identical to' if got == ref else 'differs from'} the "
                  f"in-process paged engine's", flush=True)
            if got != ref:
                fail(f"worker pair: tokens {got} differ from {ref}")
        names = ("exported", "adopted", "failed", "fallback")

        def counters():
            return {k: _series(pre_url if k != "adopted" else dec_url,
                               f"kftpu_engine_handoffs_{k}_total")
                    for k in names}

        c0 = counters()
        target, stamped, base = _decode_backend_target(pre_url, dec_url)
        http.client.HTTPConnection = stamped
        try:
            run, rep = run_mixed(target, "ServerTarget, prefill + decode "
                                 "workers", card, pre_url)
        finally:
            http.client.HTTPConnection = base
        c1 = counters()
        moved = {k: c1[k] - c0[k] for k in names}
        multi = sum(1 for o in run.outcomes if o.tokens > 1)
        for _ in range(100):
            resident = (_resident_pages(pre_url), _resident_pages(dec_url))
            if resident == (0.0, 0.0):
                break
            time.sleep(0.1)
        print(f"worker pair mixed_interference: handoffs {json.dumps(moved)}"
              f", requests with tokens to decode {multi}, pages resident "
              f"after the run (prefill, decode) {resident}", flush=True)
        if rep["by_status"] != {"ok": rep["requests"]}:
            fail(f"worker pair: statuses {rep['by_status']}")
        if not (moved["exported"] == moved["adopted"] == multi) or \
                moved["failed"] or moved["fallback"]:
            fail(f"worker pair: handoff counters {moved} against {multi} "
                 "requests with tokens to decode")
        if resident != (0.0, 0.0):
            fail(f"worker pair: pages resident after the run {resident}")
        for label, r in (("unified worker", unified),
                         ("prefill + decode workers", rep)):
            cls = {k: {"completed": v["completed"], "ttft_ms": v["ttft_ms"],
                       "tpot_ms": v["tpot_ms"]}
                   for k, v in r.get("qos", {}).items()}
            print(f"mixed_interference side by side, {label}: TTFT p50 "
                  f"{r['ttft_ms'].get('p50')} p95 {r['ttft_ms'].get('p95')} "
                  f"ms, TPOT p50 {r['tpot_ms'].get('p50')} p95 "
                  f"{r['tpot_ms'].get('p95')} ms, {r['tokens_per_sec']} "
                  f"tokens/s, per class {json.dumps(cls)}; {card}",
                  flush=True)

        sigterm_worker(dec, dec_url, "decode worker")
        raw = _post(pre_url + "/v1/completions",
                    {"prompt": text(*WORKER_PROMPTS[0]), "max_tokens": 16},
                    headers=hdr)[1]
        got = [int(t) for t in json.loads(raw)["choices"][0]["text"].split()]
        fb = _series(pre_url, "kftpu_engine_handoffs_fallback_total")
        print(f"worker pair fallback with the decode worker gone: tokens "
              f"{'identical to' if got == want[0] else 'differ from'} "
              f"want[0], fallback counter {fb:.0f}", flush=True)
        if got != want[0] or fb != 1:
            fail(f"worker pair fallback: tokens {got}, counter {fb}")
        sigterm_worker(pre, pre_url, "prefill worker")
        ok = True
    finally:
        reap_worker(dec, dec_log, "decode worker", ok)
        reap_worker(pre, pre_log, "prefill worker", ok)


def phase_disaggregated(want: list[list[int]], unified: dict,
                        card: str) -> None:
    """(e): the handoff and the host tier in process on a fresh 32-layer
    engine (the serving seed, so the same weights as the workers'), then
    the prefill/decode worker pair once those engines are freed."""
    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    uni = LLMEngine(preset("llama3-8b"), BatchingSpec(**PAGED_SPEC),
                    seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"disaggregated: unified paged engine ready in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated",
          flush=True)
    adopted = handoff_in_process(uni)
    promoted = host_tier_in_process(uni, card)
    print(f"disaggregated kernels: paged_decode launches on adopted pages "
          f"{adopted}, on promoted pages {promoted}", flush=True)
    del uni
    gc.collect()
    torch.cuda.empty_cache()
    phase_worker_pair(want, unified, card)


# -- (f) the fleet's failure path: the remote KV tier, the router, chaos -----

#: The remote tier's engines: PAGED_SPEC with 16 host pages, 0.5 s to
#: demote and 0.5 s more to spill, and an explicit store deadline. The
#: default deadline (0.5 s, the JAX package's, left as it is) bounds all of
#: one match's probes and reads; one bf16 page blob of Llama-3-8B holds
#: 16,777,216 B of KV, so a 700-token turn reads and hashes ~84 MB inside
#: it. 2 s leaves a loaded host room, so the phase measures the promote
#: instead of cutting it; the printed promote time says whether 0.5 s would
#: have.
FLEET_TIER = dict(host_kv_pages=16, kv_demote_after_s=0.5,
                  kv_remote_after_s=0.5, kv_remote_deadline_s=2.0)
#: (f)1's conversation: turn 1 (700 tokens: five full 128-token pages and a
#: partial one), then turn 1 + its output + 16 new tokens.
FLEET_TURNS = ((700, 81), (17, 82))
#: (f)2's conversation over HTTP: turn 2 is turn 1's text and 16 more
#: characters (``TokenIdText`` encodes bytes, so the random model's output
#: ids cannot ride in a prompt; the five stored pages are the same prefix).
FLEET_HTTP_TURNS = ((700, 91), (17, 92))
#: A wedged store may cost at most the deadline plus a cold prefill, and
#: this much more for the scheduler step around the match.
WEDGE_SLACK_S = 0.5
EXPLICIT_STATUSES = {200, 429, 500, 502, 503, 504}


def _host_timed(obj, name: str, sink: list) -> None:
    """Wrap ``obj.name`` to append its host seconds to ``sink`` (no device
    sync: the store's work is host work, some of it on the migration
    thread)."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            sink.append(time.perf_counter() - t0)

    setattr(obj, name, run)


def _wait_spilled(eng, pages: int, label: str) -> float:
    """Step the idle engine until ``pages`` pages are in the store and no
    spill is in flight; returns the seconds it took."""
    t0 = time.perf_counter()
    while eng.kv_tier_stats()["pages_demoted_remote"] < pages:
        eng.step()
        time.sleep(0.02)
        if time.perf_counter() - t0 > 60:
            fail(f"{label}: not {pages} pages spilled after 60 s: "
                 f"{eng.kv_tier_stats()}")
    eng._kvtier.drain_migrations(60.0)
    return time.perf_counter() - t0


def _first_difference(a: list, b: list) -> str:
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             None if len(a) == len(b) else min(len(a), len(b)))
    return "equal" if i is None else f"first different at token {i}"


def _blobs_equal_planes(nodes: dict, before: dict, store) -> int:
    """Every node of ``nodes`` (old page -> node) that reached the store:
    its blob must decode to the planes read before demotion. Returns how
    many were checked."""
    from kubeflow_tpu_torch.serve.handoff import pages_from_wire, to_torch
    from kubeflow_tpu_torch.serve.kvtier import TIER_REMOTE

    checked = 0
    for j, node in enumerate(nodes.values()):
        if node.tier != TIER_REMOTE:
            continue
        planes = pages_from_wire(store.get_bytes(node.blob))
        for name, arr in zip(("k", "v", "ks", "vs"), planes):
            if name not in before:
                continue
            if arr is None or not torch.equal(to_torch(arr),
                                              before[name][:, j].cpu()):
                fail(f"store blob {node.blob}: plane {name} differs from "
                     "the page read before demotion")
        checked += 1
    return checked


def fleet_in_process(uni, root: str, card: str) -> int:
    """(f)1. Engine A (``FLEET_TIER`` on ``root``) serves a 700-token turn,
    demotes and spills it while idle: five full pages reach the store (the
    partial page stays on the host), each blob decoding to the page's bytes
    read before demotion. A closes; engine B on the same weights and root
    serves turn 2, whose greedy tokens must equal a cold engine's without
    the tier, adopting the prefix from the store (registry hits, remote
    promotions >= 5, a prefix hit) with the paged-decode kernel running on
    the promoted pages. Then a ``ChaosStore`` under a fresh engine: one
    truncated read counts a corrupt blob, a wedged store a promote timeout,
    both with the same tokens, the wedged turn's TTFT within the deadline
    plus a cold prefill. bf16 pages, then int8. Returns the paged-decode
    launches on promoted pages."""
    from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention
    from kubeflow_tpu_torch.pipelines.artifacts import ArtifactStore
    from kubeflow_tpu_torch.serve.engine import SamplingParams
    from kubeflow_tpu_torch.serve.faults import ChaosStore

    tok = TokenIdText()
    params = SamplingParams(max_new_tokens=16, temperature=0.0,
                            stop_token=tok.eos_id)
    turn1 = tok.encode(text(*FLEET_TURNS[0]))
    store = ArtifactStore(root)
    deadline_s = FLEET_TIER["kv_remote_deadline_s"]
    total = 0
    for quant in (None, "int8"):
        label = "fleet " + ("int8" if quant else "bf16")

        def tiered():
            return paged_engine(uni, kv_cache_dtype=quant,
                                remote_kv_root=root, **FLEET_TIER)

        a = tiered()
        spills: list = []
        _host_timed(a._kvtier, "_remote_publish", spills)
        out1 = _drive(a, a.submit(turn1, params)).output_tokens
        torch.cuda.synchronize()
        nodes = {p: a._kvtier._by_page[p]
                 for p in a._allocator.reclaimable_lru()}
        before = _planes(a, list(nodes))
        t_spill = _wait_spilled(a, 5, label)
        st_a = a.kv_tier_stats()
        checked = _blobs_equal_planes(nodes, before, store)
        if checked < 5:
            fail(f"{label}: {checked} of {len(nodes)} pages in the store")
        wire = st_a["remote_demote_bytes"] / st_a["pages_demoted_remote"]
        _settle(a, label + " (engine A)")
        a.stop()
        del a, before
        torch.cuda.empty_cache()

        turn2 = turn1 + out1 + tok.encode(text(*FLEET_TURNS[1]))[1:]
        base = paged_engine(uni, kv_cache_dtype=quant)
        cold = _drive(base, base.submit(turn2, params))
        want = cold.output_tokens
        _settle(base, label + " (without the tier)")
        del base

        b = tiered()
        probe, fetch, upload = [], [], []
        _host_timed(b._kvtier, "_probe_remote_child", probe)
        _host_timed(b._kvtier, "_fetch_remote_blob", fetch)
        _timed(b._kvtier, "_upload_pages", upload)
        paged_decode_attention.launches = 0
        hot = _drive(b, b.submit(turn2, params))
        launches = paged_decode_attention.launches
        st_b = b.kv_tier_stats()
        print(f"{label}: turn 1 {len(turn1)} tokens, {checked} pages spilled "
              f"to the store in {t_spill:.3f} s after the turn (idle timers "
              f"{FLEET_TIER['kv_demote_after_s']} + "
              f"{FLEET_TIER['kv_remote_after_s']} s included), each blob "
              f"equal to its page's bytes; spill {sum(spills) / len(spills):.4f}"
              f" s per page (put + sha256 + register; the migration thread "
              f"is busy {sum(spills):.3f} s, which a demotion batch queued "
              f"behind the spill waits), {wire:.0f} wire bytes per page; "
              f"turn 2 ({len(turn2)} tokens) promoted "
              f"{st_b['pages_promoted_remote']} pages "
              f"({st_b['remote_promote_bytes']} bytes): probe "
              f"{sum(probe):.4f} s, read + sha256 {sum(fetch):.4f} s, upload "
              f"{sum(upload):.4f} s (deadline {deadline_s} s; the 0.5 s "
              f"default {'holds' if sum(probe) + sum(fetch) < 0.5 else 'would cut it'}"
              f"); TTFT {hot.ttft:.4f} s from the store against "
              f"{cold.ttft:.4f} s cold without the tier; tokens "
              f"{'identical to' if hot.output_tokens == want else 'differ from'}"
              f" the cold engine's; registry hits "
              f"{st_b['remote_registry_hits']}, prefix hits "
              f"{st_b['prefix_hits']}; paged_decode launches on promoted "
              f"pages {launches}; {card}", flush=True)
        if hot.output_tokens != want:
            fail(f"{label}: turn 2 tokens {hot.output_tokens} differ from "
                 f"{want}")
        if st_b["remote_registry_hits"] < 5 or \
                st_b["pages_promoted_remote"] < 5 or st_b["prefix_hits"] < 1 \
                or launches <= 0:
            fail(f"{label}: store hit counters {st_b}, decode launches "
                 f"{launches}")
        total += launches
        _settle(b, label + " (engine B)")
        b.stop()
        del b

        for fault, counter in (("truncate", "remote_blobs_corrupt"),
                               ("wedge", "remote_promote_timeouts")):
            c = tiered()
            chaos = ChaosStore(c._kvtier._remote_store)
            c._kvtier._remote_store = chaos
            if fault == "truncate":
                chaos.truncate_next(1)
            else:
                chaos.wedge_promote()
            try:
                r = _drive(c, c.submit(turn2, params))
            finally:
                chaos.unwedge()
                chaos.truncate_next(0)
            st_c = c.kv_tier_stats()
            print(f"{label} chaos {fault}: {counter} {st_c[counter]}, "
                  f"chaos {json.dumps(chaos.stats)}, TTFT {r.ttft:.4f} s, "
                  f"tokens {'identical to' if r.output_tokens == want else 'differ from'}"
                  f" the cold engine's", flush=True)
            if st_c[counter] < 1 or r.output_tokens != want:
                fail(f"{label} chaos {fault}: {counter} {st_c[counter]}, "
                     f"tokens {r.output_tokens} against {want}")
            if fault == "wedge" and \
                    r.ttft > deadline_s + cold.ttft + WEDGE_SLACK_S:
                fail(f"{label}: the wedged turn's TTFT {r.ttft:.3f} s is over "
                     f"the deadline {deadline_s} s + the cold prefill "
                     f"{cold.ttft:.3f} s + {WEDGE_SLACK_S} s")
            _settle(c, f"{label} chaos {fault}")
            c.stop()
            del c
        torch.cuda.empty_cache()
    return total


def _ask(url: str, prompt: str, timeout: float = 600.0):
    """(status, token ids) of one completion; a connection-level failure is
    the explicit 502."""
    try:
        status, raw = _post(url + "/v1/completions",
                            {"prompt": prompt, "max_tokens": 16},
                            timeout=timeout)
    except urllib.error.HTTPError as exc:
        exc.read()
        return exc.code, None
    except OSError:
        return 502, None
    return status, [int(t) for t in
                    json.loads(raw)["choices"][0]["text"].split()]


def fleet_workers(want: list[list[int]], root: str, card: str) -> None:
    """(f)2. Two ``model_server`` workers (unified, page pool,
    ``FLEET_TIER`` on one shared ``root``) behind a port ``Router`` in this
    process. Turn 1 through the router; the home worker (the one whose
    ``kftpu_engine_kv_pages_remote`` reaches 5) is SIGKILLed; turn 2
    through the router must answer 200 with ``want[1]``, served by the
    survivor from the store (promoted bytes > 0, a prefix hit). Then 8
    requests: every status explicit, at least 4 ok, the dead backend
    ejected. SIGTERM ends the survivor with 143."""
    from kubeflow_tpu_torch.serve.router import Router

    batching = dict(PAGED_SPEC, remote_kv_root=root, **FLEET_TIER)
    t0 = time.perf_counter()
    workers = [spawn_worker(batching, f"fleet-worker-{i}") for i in (0, 1)]
    router = Router(queue_timeout=30.0, eject_threshold=2, eject_period=60.0,
                    max_retries=2, upstream_timeout=600.0)
    ok = False
    try:
        for i, (proc, url, _log) in enumerate(workers):
            wait_ready(proc, url, f"fleet worker {i}", t0)
        urls = [url for _, url, _ in workers]
        router.set_backends({"latest": urls})
        router.start()
        print(f"fleet workers ready in {time.perf_counter() - t0:.1f} s "
              f"behind the router at {router.url}", flush=True)
        turn1 = text(*FLEET_HTTP_TURNS[0])
        st, got = _ask(router.url, turn1)
        if st != 200 or got != want[0]:
            fail(f"fleet turn 1: status {st}, tokens {got} against {want[0]}")
        t1 = time.perf_counter()
        while True:
            remote = [_series(u, "kftpu_engine_kv_pages_remote") for u in urls]
            if max(remote) >= 5:
                break
            if time.perf_counter() - t1 > 60:
                fail(f"fleet: no worker spilled five pages in 60 s: {remote}")
            time.sleep(0.2)
        home = remote.index(max(remote))
        hproc, hurl, _ = workers[home]
        surv_url = urls[1 - home]
        t_spill = time.perf_counter() - t1
        hproc.kill()
        rc = hproc.wait(timeout=60)
        print(f"fleet: worker {home} held the conversation ({remote[home]:.0f}"
              f" pages in the store {t_spill:.2f} s after turn 1); SIGKILL ->"
              f" exit code {rc}", flush=True)
        turn2 = turn1 + text(*FLEET_HTTP_TURNS[1])
        t2 = time.perf_counter()
        st, got = _ask(router.url, turn2)
        t_turn2 = time.perf_counter() - t2
        promoted = _series(surv_url, "kftpu_engine_kv_remote_promoted_bytes_total")
        hits = _series(surv_url, "kftpu_engine_kv_prefix_hits_total")
        print(f"fleet turn 2 through the router: status {st}, tokens "
              f"{'identical to' if got == want[1] else 'differ from'} the "
              f"in-process engine's, {t_turn2:.3f} s; the survivor promoted "
              f"{promoted:.0f} bytes from the store, prefix hits {hits:.0f}; "
              f"router {json.dumps(router.snapshot())}; {card}", flush=True)
        if st != 200 or got != want[1]:
            fail(f"fleet turn 2: status {st}, tokens {got} against {want[1]}")
        if promoted <= 0 or hits < 1:
            fail(f"fleet: the survivor did not adopt from the store "
                 f"(promoted bytes {promoted}, prefix hits {hits})")
        statuses = [_ask(router.url, text(60, 100 + i))[0] for i in range(8)]
        snap = router.snapshot()
        print(f"fleet: 8 requests after the kill {statuses}; router "
              f"{json.dumps(snap)}", flush=True)
        if not set(statuses) <= EXPLICIT_STATUSES or \
                statuses.count(200) < 4:
            fail(f"fleet: statuses {statuses}")
        if snap["ejections"] < 1 or snap["ejected"] < 1:
            fail(f"fleet: the dead worker was not ejected: {snap}")
        sproc, _, _ = workers[1 - home]
        sigterm_worker(sproc, surv_url, "fleet survivor")
        ok = True
    finally:
        router.stop()
        for i, (proc, _url, log) in enumerate(workers):
            # The SIGKILLed worker's log is dropped like a clean one's.
            reap_worker(proc, log, f"fleet worker {i}", ok)


def phase_fleet(card: str) -> None:
    """(f): the remote KV tier in process on a fresh 32-layer engine (the
    serving seed), bf16 and int8 pages, then — with that engine freed —
    two worker processes behind the router, one SIGKILLed. The store roots
    are a temporary directory, removed at the end."""
    import tempfile

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_kv_store_")
    try:
        uni = LLMEngine(preset("llama3-8b"), BatchingSpec(**PAGED_SPEC),
                        seed=SEED, device="cuda")
        promoted = fleet_in_process(uni, os.path.join(root, "engines"), card)
        # (f)2's reference: the survivor's path in process on its own
        # store root — one engine serves turn 1 and spills it, a fresh one
        # serves turn 2 from the store (five full pages adopted, the rest
        # prefilled). Greedy bf16 tokens of a random-weight model follow
        # the prefill's chunk boundaries, so a cold engine (chunks from 0)
        # and one that saw turn 1 (a copy-on-write tail) may pick others:
        # both are printed beside it, not held. Tokens equal to this
        # reference show the survivor adopted the stored KV; a recompute
        # would give the cold engine's.
        tok = TokenIdText()
        params = SamplingParams(max_new_tokens=16, temperature=0.0,
                                stop_token=tok.eos_id)
        turns = [text(*FLEET_HTTP_TURNS[0])]
        turns.append(turns[0] + text(*FLEET_HTTP_TURNS[1]))

        def greedy(eng, prompt):
            return [t for t in eng.generate(tok.encode(prompt), params)
                    if t != tok.eos_id]

        ref_root = os.path.join(root, "reference")
        home = paged_engine(uni, remote_kv_root=ref_root, **FLEET_TIER)
        want = [greedy(home, turns[0])]
        _wait_spilled(home, 5, "fleet reference")
        home.stop()
        survivor = paged_engine(uni, remote_kv_root=ref_root, **FLEET_TIER)
        want.append(greedy(survivor, turns[1]))
        if survivor.kv_tier_stats()["pages_promoted_remote"] < 5:
            fail(f"fleet reference: turn 2 missed the store: "
                 f"{survivor.kv_tier_stats()}")
        survivor.stop()
        cold = paged_engine(uni, enable_prefix_caching=False)
        warm = paged_engine(uni)
        cow = [greedy(warm, p) for p in turns][1]
        print(f"fleet reference turn 2 from the store against a cold "
              f"engine: {_first_difference(want[1], greedy(cold, turns[1]))};"
              f" against an engine that saw turn 1 (copy-on-write tail of "
              f"{warm.kv_tier_stats()['tokens_cow']} tokens): "
              f"{_first_difference(want[1], cow)}; {card}", flush=True)
        del home, survivor, cold, warm, uni
        gc.collect()
        torch.cuda.empty_cache()
        print(f"fleet: paged_decode launches on pages promoted from the "
              f"store {promoted}; in-process engines freed, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
              flush=True)
        fleet_workers(want, os.path.join(root, "workers"), card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


TRAIN_MODEL = dict(n_layers=4, remat_policy="nothing_saveable")
TRAIN_DATA = dict(seq_len=2048, global_batch=2)


def _train_wrappers() -> dict:
    """The launch counters of the training path: the flash kernels, and
    with fused kernels on the norm, SwiGLU and CE kernels."""
    from kubeflow_tpu_torch.ops import flash_attention as FA
    from kubeflow_tpu_torch.ops import fused_norm as fn
    from kubeflow_tpu_torch.ops import fused_xent as fx

    return {"flash_fwd": FA.flash_attention,
            "flash_bwd_dkdv": FA.flash_bwd_dkdv,
            "flash_bwd_dq": FA.flash_bwd_dq,
            "rmsnorm_fwd": fn.rmsnorm_fused,
            "add_rmsnorm_fwd": fn.add_rmsnorm_fused,
            "swiglu_fwd": fn.swiglu_fused,
            "rmsnorm_bwd": fn.rmsnorm_bwd,
            "swiglu_bwd": fn.swiglu_bwd,
            "fused_xent_fwd": fx.xent_fwd,
            "fused_xent_bwd_dh": fx.dh_kernel,
            "fused_xent_bwd_dw": fx.dw_kernel}


def _want_per_step(fused: bool, n_layers: int) -> dict:
    """Launches per training step, derived from the code: each layer runs
    under ``nothing_saveable`` remat, so its forward launches twice (the
    forward and the backward's replay, which must reach the down
    projection: it saves the SwiGLU output); the final norm and the CE run
    once, outside the layers. Backward: one RMSNorm backward per norm (ln1,
    the residual ln2, the final norm), one SwiGLU, dK/dV and dQ per layer,
    one CE backward (its d_hidden and d_head kernels) per step."""
    L = n_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L}
    fused_counts = {"rmsnorm_fwd": 2 * L + 1, "add_rmsnorm_fwd": 2 * L,
                    "swiglu_fwd": 2 * L, "rmsnorm_bwd": 2 * L + 1,
                    "swiglu_bwd": L, "fused_xent_fwd": 1,
                    "fused_xent_bwd_dh": 1, "fused_xent_bwd_dw": 1}
    for k, v in fused_counts.items():
        want[k] = v if fused else 0
    return want


def phase_train_check() -> None:
    """Kernel paths vs the plain path on the training slice: Llama-3-8B
    widths, 4 layers, fp32 params from a seed, one synthetic 2 x 2048
    batch; one ``decoder_loss`` forward and backward three ways: plain
    (``fused_kernels="off"``, ``attn_impl="xla"``), the flash kernels
    alone (``"off"``, ``"pallas"``), and every kernel (``"on"``,
    ``"pallas"``). Loss and gradients are held against the plain run's:
    layer-0 wq/wk/wv and the embedding for the flash kernels; those and
    layer-0 ln1, ln2, mlp gate and up, the final norm and the head for
    every kernel. Then three steps of the preset configuration
    (``fused_kernels="auto"``: on) on that batch, repeated, must lower the
    loss."""
    import dataclasses

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
    lay = p["layers"]
    leaves = {"wq[0]": lay["attn"]["wq"], "wk[0]": lay["attn"]["wk"],
              "wv[0]": lay["attn"]["wv"], "embed": p["embed"],
              "ln1[0]": lay["ln1"], "ln2[0]": lay["ln2"],
              "gate[0]": lay["mlp"]["gate"], "up[0]": lay["mlp"]["up"],
              "final_norm": p["final_norm"], "lm_head": p["lm_head"]}
    stacked = {"wq[0]", "wk[0]", "wv[0]", "ln1[0]", "ln2[0]", "gate[0]",
               "up[0]"}
    flash_leaves = ("wq[0]", "wk[0]", "wv[0]", "embed")

    def run(fused: str, impl: str):
        loss, _ = decoder_loss(p, batch, dataclasses.replace(
            cfg, fused_kernels=fused), attn_impl=impl)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), {n: (g[0] if n in stacked else g)
                             for n, g in zip(leaves, grads)}

    lp, gp = run("off", "xla")
    for label, fused, names in (("flash kernels", "off", flash_leaves),
                                ("every kernel", "on", tuple(leaves))):
        lk, gk = run(fused, "pallas")
        loss_rel = abs(lk - lp) / abs(lp)
        rels = {n: rel_l2(gk[n], gp[n]) for n in names}
        print(f"train check ({label}, fused_kernels={fused!r}, "
              f"attn_impl='pallas'): loss {lk:.6f} vs plain {lp:.6f} (rel "
              f"{loss_rel:.3e}, tolerance {TRAIN_LOSS_REL:g}); grad rel L2 "
              + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
              + f" (tolerance {TRAIN_GRAD_REL_L2:g})", flush=True)
        if not loss_rel <= TRAIN_LOSS_REL:
            fail(f"training loss through the {label} disagrees with the "
                 "plain path")
        bad = [n for n, r in rels.items() if not r <= TRAIN_GRAD_REL_L2]
        if bad:
            fail(f"training gradients through the {label} disagree: {bad}")
        del gk
    del gp
    losses = []
    for _ in range(3):
        _, m = task.step_fn(task.state, batch)
        losses.append(float(m["loss"]))
    print(f"train check: a repeated batch over 3 steps (fused_kernels "
          f"{cfg.fused_kernels!r}): losses {[round(x, 4) for x in losses]}",
          flush=True)
    if not losses[-1] < losses[0]:
        fail("three steps on a repeated batch did not lower the loss")
    del task, p, lay, leaves
    gc.collect()
    torch.cuda.empty_cache()


class _Crash(Exception):
    """Ends a training run right after its step-3 checkpoint."""


def _trainer_cfg(ckpt_dir=None, steps: int = 6, **model):
    from kubeflow_tpu_torch.train.trainer import TrainerConfig

    return TrainerConfig(
        model="llama3-8b", model_overrides={**TRAIN_MODEL, **model},
        data=dict(TRAIN_DATA), steps=steps, log_every=1, seed=SEED,
        attn_impl="pallas",
        optimizer={"learning_rate": 3e-4, "warmup_steps": 2,
                   "clip_norm": 1.0},
        checkpoint_dir=ckpt_dir, checkpoint_every=3 if ckpt_dir else 0,
        max_checkpoints=1)


def _train_run(cfg, workdir: str, crash_at=None,
               keep_params: bool = False) -> tuple[dict, float]:
    """One ``Trainer.run()``; returns ({step: metrics}, seconds). A
    ``crash_at`` step raises after that step's checkpoint. The last step's
    entry also holds ``opt_state``: the optimizer count and the layer-0 wq
    Adam moments, on the host; with ``keep_params``, ``params16``: the
    params cast to bf16 in memory, on the card."""
    from kubeflow_tpu_torch.train import tree as T
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
            if keep_params:
                seen[step]["params16"] = T.map_tree(
                    lambda t: t.detach().to(torch.bfloat16),
                    trainer.task.state["params"])
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


def _counted_run(cfg, workdir: str, label: str) -> dict:
    """``_train_run`` with every training kernel's count set to 0 just
    before and read just after; checks finite losses, the steps taken and
    the per-step launches derived by ``_want_per_step``. Returns the
    metrics by step and the launches."""
    from kubeflow_tpu_torch.models.config import preset

    wrappers = _train_wrappers()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    seen, secs = _train_run(cfg, workdir)
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for step, m in sorted(seen.items()):
        print(f"{label} step {step}: loss {m['loss']:.6f} grad_norm "
              f"{m['grad_norm']:.4f} step_time_ms "
              f"{m.get('step_time_ms', float('nan')):.1f} tokens/s "
              f"{m.get('tokens_per_sec', float('nan')):.0f} mfu "
              f"{m.get('mfu', float('nan')):.4f}", flush=True)
    print(f"{label}: {cfg.steps} steps in {secs:.1f} s (init included), "
          f"peak {peak / 2**30:.2f} GiB allocated; kernels "
          + json.dumps(launches), flush=True)
    if sorted(seen) != list(range(1, cfg.steps + 1)):
        fail(f"{label}: steps {sorted(seen)} reported, not 1..{cfg.steps}")
    for step, m in seen.items():
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            fail(f"{label} step {step}: non-finite loss or grad norm {m}")
    mcfg = preset(cfg.model, **cfg.model_overrides)
    fused = mcfg.fused_kernels in ("on", "auto")      # auto: on, on a card
    want = {n: c * cfg.steps
            for n, c in _want_per_step(fused, mcfg.n_layers).items()}
    if launches != want:
        fail(f"{label}: kernel launches {launches}, expected {want}")
    return {"steps": seen, "launches": launches}


def phase_train(rows: list[dict]) -> None:
    """The training slice through its entry point, ``Trainer.run()``: the
    preset configuration (``fused_kernels="auto"``, every kernel) for 6
    steps, then a crash after a step-3 checkpoint and a resume; then 2
    steps with ``fused_kernels="off"`` (the flash kernels, chunked CE)."""
    import tempfile

    # Under the checkout (git-ignored), not $TMPDIR: a step-3 checkpoint of
    # this model is 23 GB, more than a small temporary filesystem holds.
    work = tempfile.mkdtemp(prefix=".chip_smoke_train_",
                            dir=Path(__file__).resolve().parent)
    try:
        for sub in ("whole", "resume", "off"):
            os.makedirs(os.path.join(work, sub))
        run = _counted_run(_trainer_cfg(), os.path.join(work, "whole"),
                           "train")
        whole, launches = run["steps"], run["launches"]
        for r in rows:
            if r["name"] in ("flash_bwd_dkdv", "flash_bwd_dq", "rmsnorm_bwd",
                             "swiglu_bwd", "fused_xent_fwd",
                             "fused_xent_bwd_dh", "fused_xent_bwd_dw"):
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
        resumed, secs_b = _train_run(_trainer_cfg(ckpt), resume_dir,
                                     keep_params=True)
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
        params16 = resumed[6].pop("params16")
        for step, m in {**first, **resumed}.items():
            if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                fail(f"train resume step {step}: non-finite {m}")
        timed_phase("file:// serve", phase_file_params, ckpt, params16)
        del params16
        shutil.rmtree(ckpt, ignore_errors=True)
        _counted_run(_trainer_cfg(steps=2, fused_kernels="off"),
                     os.path.join(work, "off"), "train fused_kernels='off'")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_file_params(ckpt: str, params16: dict) -> None:
    """(d) ``load_params("file://...")`` of the resumed run's step-6
    checkpoint into the 4-layer preset with bf16 params: the same bits as
    the trainer's params cast to bf16 in memory, and the same greedy tokens
    from an engine on each (three prompts: a 128-bucket, a 512-bucket and a
    chunked one). An empty directory must raise ``FileNotFoundError``."""
    import tempfile

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serve.storage import load_params
    from kubeflow_tpu_torch.train import tree as T

    cfg = preset("llama3-8b", n_layers=TRAIN_MODEL["n_layers"],
                 param_dtype="bfloat16")
    t0 = time.perf_counter()
    loaded = load_params(f"file://{ckpt}", cfg, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    fl, fm = T.flatten(loaded), T.flatten(params16)
    same = list(fl) == list(fm) and all(
        fl[k].dtype == fm[k].dtype and torch.equal(fl[k], fm[k]) for k in fl)
    spec = dict(max_batch_size=8, max_seq_len=2048, prefill_attn_impl="pallas",
                chunked_prefill_tokens=1024)
    tok = TokenIdText()
    prompts = [tok.encode(text(n, salt))
               for n, salt in ((90, 71), (400, 72), (1200, 73))]
    outs = {}
    for label, params in (("file://", loaded), ("in memory", params16)):
        eng = LLMEngine(cfg, BatchingSpec(**spec), params=params,
                        device="cuda")
        outs[label] = [eng.generate(p, SamplingParams(max_new_tokens=16))
                       for p in prompts]
        del eng
        torch.cuda.empty_cache()
    print(f"file:// serve: step-6 params loaded in {t_load:.1f} s "
          f"({sum(t.numel() for t in fl.values()) / 1e9:.3f} B bf16), "
          f"{'the same bits as' if same else 'NOT the same bits as'} the "
          f"trainer's params cast in memory; greedy tokens "
          f"{'identical' if outs['file://'] == outs['in memory'] else 'DIFFER'}"
          f": {outs['file://']}", flush=True)
    if not same:
        fail("file:// serve: the loaded params differ from the trainer's")
    if outs["file://"] != outs["in memory"]:
        fail("file:// serve: greedy tokens differ from the in-memory params'")
    with tempfile.TemporaryDirectory() as empty:
        try:
            load_params(f"file://{empty}", cfg, device="cuda")
        except FileNotFoundError as exc:
            print(f"file:// serve: an empty directory raises "
                  f"FileNotFoundError: {exc}", flush=True)
        else:
            fail("file:// serve: an empty directory gave params")
    del loaded
    torch.cuda.empty_cache()


def phase_train_profile(fused: str) -> None:
    """One training step (after two warm ones) at the train phase's
    configuration with ``fused_kernels=fused``: host enqueue, wall and
    device ms, the kernels that take the device time, tokens/s and MFU
    against the card's bf16 peak, and the peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.train.data import DataConfig, SyntheticLM
    from kubeflow_tpu_torch.train.metrics import bf16_peak_flops
    from kubeflow_tpu_torch.train.optim import OptimizerConfig
    from kubeflow_tpu_torch.train.step import setup_train

    cfg = preset("llama3-8b", **TRAIN_MODEL, fused_kernels=fused)
    task = setup_train(cfg, OptimizerConfig(), device="cuda", seed=SEED,
                       attn_impl="pallas")
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seed=SEED,
                                 **TRAIN_DATA))
    batches = [torch.from_numpy(src.batch_at(i)).to("cuda") for i in range(4)]
    for b in batches[:2]:
        task.step_fn(task.state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    task.step_fn(task.state, batches[2])
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated()
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
    print(f"profile train step fused_kernels={fused!r} (llama3-8b widths, "
          f"{cfg.n_layers} layers, {TRAIN_DATA['global_batch']} x "
          f"{TRAIN_DATA['seq_len']} tokens): host enqueue "
          f"{t_enq * 1e3:.2f} ms, wall {t_wall * 1e3:.2f} ms, device "
          f"{dev_ms}, {tps:.0f} tokens/s, MFU {mfu}, peak "
          f"{peak_mem / 2**30:.2f} GiB allocated", flush=True)
    # The ten largest, and the flash and CE kernels wherever they rank.
    for rank, (key, ms, count) in enumerate(kernels):
        if rank < 10 or "flash" in key or "xent" in key:
            print(f"  {ms:8.3f} ms  {count:4d}x  {key[:90]}", flush=True)
    del task, batches
    gc.collect()
    torch.cuda.empty_cache()


def timed_phase(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def serve_phases(rows: list[dict], card: str, *, full: bool) -> tuple:
    """Phases 4 on: serve, (a) explain, (b) loadgen in process, then (with
    ``full``) the paged serve, paged check and profile; then the engine is
    freed and (c) the worker runs. Returns the worker's greedy tokens and
    its ``mixed_interference`` report, for (e)."""
    engine = timed_phase("serve", phase_serve, rows)
    timed_phase("explain", phase_explain, engine)
    timed_phase("loadgen in process", phase_loadgen_engine, engine, card)
    if full:
        timed_phase("paged serve", phase_paged_serve, engine, rows)
        timed_phase("paged check", phase_paged_check, engine)
        timed_phase("profile", phase_profile, engine)
    want = timed_phase("worker reference", worker_reference, engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serving engines freed: {torch.cuda.memory_allocated() / 2**30:.2f}"
          " GiB still allocated", flush=True)
    mixed = timed_phase("worker", phase_worker, want, card)
    return want, mixed


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
    timed_phase("build", phase_build)
    if sys.argv[1:] == ["--serve-only"]:
        want, mixed = serve_phases([], card, full=False)
        timed_phase("disaggregated", phase_disaggregated, want, mixed, card)
        timed_phase("fleet", phase_fleet, card)
        print(f"chip_smoke: serve-only phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:] in (["--flash-only"], ["--paged-only"],
                        ["--xent-only"], ["--norm-only"]):
        # One family of kernels alone: its rows, then its edge cases.
        if sys.argv[1] == "--flash-only":
            rows = flash_fwd_rows() + flash_bwd_rows()
            phase_flash_edges()
            phase_flash_bwd_edges()
        elif sys.argv[1] == "--xent-only":
            rows = xent_rows()
            phase_xent_edges()
        elif sys.argv[1] == "--norm-only":
            rows = norm_fwd_rows() + norm_swiglu_bwd_rows()
            phase_norm_edges()
            phase_norm_bwd_edges()
        else:
            rows = paged_kernel_rows()
            phase_paged_edges()
        for r in rows:
            print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
                  f"{r['plain_ms']:.4f} library_ms {r['library_ms']} "
                  f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})",
                  flush=True)
        print(f"chip_smoke: {sys.argv[1][2:]} phases passed in "
              f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    rows = timed_phase("kernels", phase_kernels)
    timed_phase("edges", phase_edges)
    timed_phase("memory probe", phase_memory_probe)
    want, mixed = serve_phases(rows, card, full=True)
    timed_phase("train check", phase_train_check)
    timed_phase("train", phase_train, rows)
    timed_phase("train profile auto", phase_train_profile, "auto")
    timed_phase("train profile off", phase_train_profile, "off")
    timed_phase("disaggregated", phase_disaggregated, want, mixed, card)
    timed_phase("fleet", phase_fleet, card)
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
