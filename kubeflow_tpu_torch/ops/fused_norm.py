"""Fused RMSNorm(+residual-add) and SwiGLU/GeGLU forwards, written in Triton
for Hopper — the port of ``kubeflow_tpu/ops/fused_norm.py``'s forward
kernels.

Kernels and what they replace:

- ``rmsnorm_fused`` / ``add_rmsnorm_fused`` — one Triton kernel with a
  ``HAS_RESIDUAL`` switch, one program per row. Replaces ``_rms_fwd_call``'s
  two ``pl.pallas_call`` sites (``_rms_fwd_kernel`` and
  ``_residual_fwd_kernel``). Same op order as the TPU kernel: the residual
  add in the native dtype, fp32 statistics, ``x * rsqrt(mean(x²)+eps) * w``
  (or ``1 + w``), cast at the store; writes ``o``, the fp32 ``rstd`` the
  backward will need, and ``y = x + res`` when the residual is on.
  Bound: bytes (a row reduction plus scaling — ~2-3 bytes of traffic per
  FLOP). Design: each row is read once into registers, reduced and scaled
  there, and written once; loads are contiguous and vectorise.
- ``swiglu_fused`` — a Triton elementwise kernel over the flat ``[T·M]``
  range: ``act(g) · u`` in fp32 (silu = ``g·sigmoid(g)``, gelu = the tanh
  form with the constants of the TPU kernel), cast at the store. Replaces
  ``_swiglu``'s ``pl.pallas_call`` (``_swiglu_fwd_kernel``). Bound: bytes
  (two reads and one write per element). Design: one pass, no
  intermediate in device memory.

Each wrapper takes its plain PyTorch version only for a CPU tensor; on a
CUDA tensor it launches its kernel (and adds one to its ``launches``
count) or raises. Triton is imported inside the launching function, so
this module imports on a machine without it.

The kernels have no backward yet (the TPU package's ``_rms_bwd_kernel``
and ``_swiglu_bwd_kernel`` are still to port), and a kernel's output has
no autograd node: under ``loss.backward()`` every parameter before it
would silently get no gradient. So each wrapper refuses to run while
gradients are being recorded for one of its inputs, on either device;
training runs with ``DecoderConfig(fused_kernels="off")``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_ACT_CODE = {"silu": 0, "gelu": 1}
SWIGLU_BLOCK = 1024


# -- plain versions (the CPU path, and the card's reference) -------------------

def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float,
                plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    wf = (1.0 + w.float()) if plus_one else w.float()
    return (xf * wf).to(x.dtype)


def add_rmsnorm_ref(x: torch.Tensor, res: torch.Tensor, w: torch.Tensor, *,
                    eps: float, plus_one: bool = False):
    y = x + res
    return y, rmsnorm_ref(y, w, eps=eps, plus_one=plus_one)


def act_ref(g: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(g)
    if act == "gelu":
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor, *,
               act: str = "silu") -> torch.Tensor:
    return (act_ref(gate.float(), act) * up.float()).to(gate.dtype)


# -- Triton kernels (built on first launch) ------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def rms_fwd(X, R, W, Y, O, RSTD, D, eps,
                HAS_RESIDUAL: tl.constexpr, PLUS_ONE: tl.constexpr,
                BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < D
        x = tl.load(X + row * D + cols, mask=mask, other=0.0)
        if HAS_RESIDUAL:
            r = tl.load(R + row * D + cols, mask=mask, other=0.0)
            x = x + r                      # native dtype, like the TPU kernel
            tl.store(Y + row * D + cols, x, mask=mask)
        xf = x.to(tl.float32)
        var = tl.sum(xf * xf, axis=0) / D
        inv = tl.rsqrt(var + eps)
        wf = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
        if PLUS_ONE:
            wf = 1.0 + wf
        o = xf * inv * wf
        tl.store(O + row * D + cols, o.to(O.dtype.element_ty), mask=mask)
        tl.store(RSTD + row, inv)

    @triton.jit
    def swiglu_fwd(G, U, O, N, ACT: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < N
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
        u = tl.load(U + offs, mask=mask, other=0.0).to(tl.float32)
        if ACT == 0:
            val = g * tl.sigmoid(g)
        else:
            # tanh-approximate gelu; sqrt(2/pi) and 0.044715 as in the TPU
            # kernel (kubeflow_tpu/ops/fused_norm.py, _act_and_grad).
            inner = 0.7978845608028654 * (g + 0.044715 * g * g * g)
            t = 2.0 * tl.sigmoid(2.0 * inner) - 1.0      # tanh(inner)
            val = 0.5 * g * (1.0 + t)
        tl.store(O + offs, (val * u).to(O.dtype.element_ty), mask=mask)

    return {"rms": rms_fwd, "swiglu": swiglu_fwd, "next_pow2":
            triton.next_power_of_2}


def _require_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} (the kernel takes CUDA "
                         "tensors; the plain version takes CPU tensors)")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")


def _refuse_grad(name: str, *ts: torch.Tensor) -> None:
    """Raise when autograd records through this call: the kernel's output
    would cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: the kernel has no backward yet, so its output would "
            "cut the autograd graph; train with "
            "DecoderConfig(fused_kernels='off') until the fused-kernel "
            "training slice brings the RMSNorm and SwiGLU backward kernels "
            "(ROADMAP Queue 1 item 3b)")


def _norm_launch(x2, r2, w, eps: float, plus_one: bool):
    rows, d = x2.shape
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} != ({d},)")
    k = _kernels()
    block = k["next_pow2"](d)
    if block > 65536:
        raise ValueError(f"rmsnorm: hidden {d} exceeds one program's row")
    o = torch.empty_like(x2)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x2.device)
    y = torch.empty_like(x2) if r2 is not None else o
    num_warps = min(max(block // 512, 1), 16)
    k["rms"][(rows,)](x2, r2 if r2 is not None else x2, w, y, o, rstd, d,
                      float(eps), HAS_RESIDUAL=r2 is not None,
                      PLUS_ONE=bool(plus_one), BLOCK=block,
                      num_warps=num_warps)
    return y, o, rstd


def rmsnorm_fused(x: torch.Tensor, w: torch.Tensor, *, eps: float,
                  plus_one: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim; ``x`` [..., D], ``w`` [D]."""
    _refuse_grad("rmsnorm_fused", x, w)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps, plus_one=plus_one)
    _require_cuda("rmsnorm_fused", x, w)
    d = x.shape[-1]
    _, o, _ = _norm_launch(x.reshape(-1, d).contiguous(), None,
                           w.contiguous(), eps, plus_one)
    rmsnorm_fused.launches += 1
    return o.reshape(x.shape)


def add_rmsnorm_fused(x: torch.Tensor, res: torch.Tensor, w: torch.Tensor,
                      *, eps: float, plus_one: bool = False):
    """``y = x + res; h = rmsnorm(y)`` in one pass; returns ``(y, h)``."""
    if x.shape != res.shape or x.dtype != res.dtype:
        raise ValueError(f"add_rmsnorm: x {tuple(x.shape)}/{x.dtype} vs "
                         f"res {tuple(res.shape)}/{res.dtype}")
    _refuse_grad("add_rmsnorm_fused", x, res, w)
    if x.device.type == "cpu":
        return add_rmsnorm_ref(x, res, w, eps=eps, plus_one=plus_one)
    _require_cuda("add_rmsnorm_fused", x, res, w)
    d = x.shape[-1]
    y, o, _ = _norm_launch(x.reshape(-1, d).contiguous(),
                           res.reshape(-1, d).contiguous(), w.contiguous(),
                           eps, plus_one)
    add_rmsnorm_fused.launches += 1
    return y.reshape(x.shape), o.reshape(x.shape)


def swiglu_fused(gate: torch.Tensor, up: torch.Tensor, *,
                 act: str = "silu") -> torch.Tensor:
    """``act(gate) * up`` over matching [..., M] inputs (silu → SwiGLU,
    gelu → GeGLU)."""
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError(f"gate {tuple(gate.shape)}/{gate.dtype} != "
                         f"up {tuple(up.shape)}/{up.dtype}")
    if act not in _ACT_CODE:
        raise ValueError(f"unknown activation {act!r}")
    _refuse_grad("swiglu_fused", gate, up)
    if gate.device.type == "cpu":
        return swiglu_ref(gate, up, act=act)
    _require_cuda("swiglu_fused", gate, up)
    g, u = gate.contiguous(), up.contiguous()
    out = torch.empty_like(g)
    n = g.numel()
    k = _kernels()
    k["swiglu"][(-(-n // SWIGLU_BLOCK),)](
        g, u, out, n, ACT=_ACT_CODE[act], BLOCK=SWIGLU_BLOCK, num_warps=4)
    swiglu_fused.launches += 1
    return out


rmsnorm_fused.launches = 0
add_rmsnorm_fused.launches = 0
swiglu_fused.launches = 0
