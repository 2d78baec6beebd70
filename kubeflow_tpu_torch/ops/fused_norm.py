"""Fused RMSNorm(+residual-add) and SwiGLU/GeGLU, forward and backward,
written in Triton for Hopper — the port of ``kubeflow_tpu/ops/fused_norm.py``.

Kernels and what they replace:

- ``rms_fwd`` (behind ``rmsnorm_fused`` / ``add_rmsnorm_fused``) — one
  Triton kernel with a ``HAS_RESIDUAL`` switch, one program per row.
  Replaces ``_rms_fwd_call``'s two ``pl.pallas_call`` sites
  (``_rms_fwd_kernel`` and ``_residual_fwd_kernel``). Same op order as the
  TPU kernel: the residual add in the native dtype, fp32 statistics,
  ``x * rsqrt(mean(x²)+eps) * w`` (or ``1 + w``), cast at the store; writes
  ``o``, the fp32 ``rstd`` the backward reads, and ``y = x + res`` when the
  residual is on. Bound: bytes. Design: each row is read once into
  registers, reduced and scaled there, and written once.
- ``rms_bwd`` + ``rms_dw_sum`` (behind ``rmsnorm_bwd``) — replace
  ``_rms_bwd_call``'s ``pl.pallas_call`` (``_rms_bwd_kernel``): dx from the
  saved rstd, and dw summed over every row. The TPU grid walks the row
  blocks in order and carries dw in VMEM; here rows run in parallel, so
  each program keeps its fp32 dw partial in registers over its rows and
  writes it as one row of a ``[programs, D]`` scratch, and a second pass
  sums the partials. No float atomics: the result is the same bit for bit
  from run to run. With ``dy`` (the residual stream's cotangent of
  ``add_rmsnorm``) the kernel also adds it: dx is rounded to the
  activation dtype first, then added, as the JAX package's
  ``_add_rmsnorm_vjp_bwd`` does. Bound: bytes (x, dh, dy read once, dx
  written once). Design: the row pass is persistent, ``k`` programs per SM
  (``k`` from the compiled kernel's occupancy, at most
  ``RMS_BWD_PER_SM``, which bounds the scratch), each taking rows in a
  fixed stride; it loads the next row's x, dh (and dy) and rstd before it
  reduces the current one, so two rows per program are in flight and the
  SM does not wait on memory between one row's reduction and the next
  row's loads. The column sum runs on strips of ``RMS_DW_COLS`` columns
  (128 programs at D = 4096), each loading its whole ``[programs, strip]``
  tile at once and summing it with ``tl.sum``'s fixed tree: one trip to
  memory, not a serial loop over the partial rows.
- ``swiglu_fwd`` (behind ``swiglu_fused``) — replaces ``_swiglu``'s
  ``pl.pallas_call`` (``_swiglu_fwd_kernel``): ``act(g) · u`` in fp32
  (silu = ``g·sigmoid(g)``, gelu = the tanh form with the TPU kernel's
  constants), cast at the store. Bound: bytes.
- ``swiglu_bwd`` (behind ``swiglu_bwd``) — replaces ``_swiglu_vjp_bwd``'s
  ``pl.pallas_call`` (``_swiglu_bwd_kernel``): ``dg = do·u·act′(g)``,
  ``du = do·act(g)``, the activation and its closed-form derivative
  recomputed from g rather than stashed. Bound: bytes (three reads, two
  writes per element). Design: one elementwise pass.

``rmsnorm_fused``, ``add_rmsnorm_fused`` and ``swiglu_fused`` are
``torch.autograd.Function``s, as the JAX functions are custom VJPs: the
norms save ``(x or y, w, rstd)``, SwiGLU saves ``(g, u)``. A call that
needs no gradient (serving, under ``no_grad``) skips the Function and
launches the forward directly. Forward and backward each take the kernel
for a CUDA tensor and the plain version (``*_ref``) for a CPU tensor; on a CUDA tensor a kernel launches (adding
one to its wrapper's ``launches`` count) or the call raises. Triton is
imported inside the launching function, so this module imports on a
machine without it.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_ACT_CODE = {"silu": 0, "gelu": 1}
SWIGLU_BLOCK = 1024
# Programs per SM of the RMSNorm backward's row pass at most (its dw
# partials are [programs, D] fp32, at most RMS_BWD_PER_SM x SMs x D x 4
# bytes: ~4% over the row pass's bytes at T = D = 4096 on 132 SMs), and
# columns per program of the pass that sums them.
RMS_BWD_PER_SM = 2
RMS_DW_COLS = 32
GELU_A = 0.7978845608028654          # sqrt(2 / pi)
GELU_B = 0.044715


# -- plain versions (the CPU path, and the card's reference) -------------------

def _rms_ref(x: torch.Tensor, w: torch.Tensor, eps: float, plus_one: bool):
    """(o in x's dtype, rstd fp32 [..., 1])."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    wf = (1.0 + w.float()) if plus_one else w.float()
    return (xf * rstd * wf).to(x.dtype), rstd


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float,
                plus_one: bool = False) -> torch.Tensor:
    return _rms_ref(x, w, eps, plus_one)[0]


def add_rmsnorm_ref(x: torch.Tensor, res: torch.Tensor, w: torch.Tensor, *,
                    eps: float, plus_one: bool = False):
    y = x + res
    return y, rmsnorm_ref(y, w, eps=eps, plus_one=plus_one)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                    dh: torch.Tensor, *, plus_one: bool = False,
                    dy: torch.Tensor | None = None):
    """RMSNorm backward from the saved fp32 ``rstd`` ([T] or [T, 1]), as
    ``_rms_bwd_kernel`` computes it: x, dh [T, D] → (dx in x's dtype, dw
    [D] in w's dtype). With ``dy``, dx is rounded to x's dtype and then
    ``dy`` is added in that dtype (``_add_rmsnorm_vjp_bwd``)."""
    inv = rstd.float().reshape(-1, 1)
    xhat = x.float() * inv
    dhf = dh.float()
    wf = (1.0 + w.float()) if plus_one else w.float()
    dxhat = dhf * wf
    dw = torch.sum(dhf * xhat, dim=0)
    c = torch.mean(dxhat * xhat, dim=-1, keepdim=True)
    dx = ((dxhat - xhat * c) * inv).to(x.dtype)
    if dy is not None:
        dx = (dy + dx).to(x.dtype)
    return dx, dw.to(w.dtype)


def act_ref(g: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(g)
    if act == "gelu":
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}")


def act_grad_ref(g: torch.Tensor, act: str):
    """fp32 (act(g), act′(g)): the values through the torch ops, the
    derivatives in the closed forms of ``_act_and_grad``."""
    val = act_ref(g, act)
    if act == "silu":
        sg = torch.sigmoid(g)
        return val, sg * (1.0 + g * (1.0 - sg))
    t = torch.tanh(GELU_A * (g + GELU_B * g ** 3))
    return val, 0.5 * (1.0 + t) + \
        0.5 * g * (1.0 - t * t) * GELU_A * (1.0 + 3.0 * GELU_B * g * g)


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor, *,
               act: str = "silu") -> torch.Tensor:
    return (act_ref(gate.float(), act) * up.float()).to(gate.dtype)


def swiglu_bwd_ref(gate: torch.Tensor, up: torch.Tensor, do: torch.Tensor, *,
                   act: str = "silu"):
    """(dgate, dup) in the inputs' dtypes, ``_swiglu_bwd_kernel``'s math."""
    gf, uf, dof = gate.float(), up.float(), do.float()
    val, dval = act_grad_ref(gf, act)
    return (dof * uf * dval).to(gate.dtype), (dof * val).to(up.dtype)


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
    def rms_bwd(X, W, RSTD, DH, DY, DX, DWP, T, D, PROGS,
                HAS_DY: tl.constexpr, PLUS_ONE: tl.constexpr,
                BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        mask = cols < D
        wf = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
        if PLUS_ONE:
            wf = 1.0 + wf
        dw = tl.zeros([BLOCK], dtype=tl.float32)
        # Rows pid, pid + PROGS, ...; each iteration loads the next row
        # (masked past T) before it reduces this one.
        live = pid < T
        off = pid.to(tl.int64) * D + cols
        x_n = tl.load(X + off, mask=mask & live, other=0.0)
        dh_n = tl.load(DH + off, mask=mask & live, other=0.0)
        inv_n = tl.load(RSTD + pid, mask=live, other=0.0)
        if HAS_DY:
            dy_n = tl.load(DY + off, mask=mask & live, other=0.0)
        for row in range(pid, T, PROGS):
            off = row.to(tl.int64) * D + cols
            x, dh, inv = x_n, dh_n, inv_n
            if HAS_DY:
                dy = dy_n
            nxt = row + PROGS
            live = nxt < T
            noff = nxt.to(tl.int64) * D + cols
            x_n = tl.load(X + noff, mask=mask & live, other=0.0)
            dh_n = tl.load(DH + noff, mask=mask & live, other=0.0)
            inv_n = tl.load(RSTD + nxt, mask=live, other=0.0)
            if HAS_DY:
                dy_n = tl.load(DY + noff, mask=mask & live, other=0.0)
            xhat = x.to(tl.float32) * inv
            dhf = dh.to(tl.float32)
            dxhat = dhf * wf
            dw += dhf * xhat
            c = tl.sum(dxhat * xhat, axis=0) / D
            dx = ((dxhat - xhat * c) * inv).to(DX.dtype.element_ty)
            if HAS_DY:
                dx = (dy.to(tl.float32) + dx.to(tl.float32)).to(
                    DX.dtype.element_ty)
            tl.store(DX + off, dx, mask=mask)
        tl.store(DWP + pid.to(tl.int64) * D + cols, dw, mask=mask)

    @triton.jit
    def rms_dw_sum(DWP, DW, P, D, ROWS: tl.constexpr, COLS: tl.constexpr):
        # The whole [P, COLS] strip at once, summed in tl.sum's fixed tree:
        # deterministic.
        cols = tl.program_id(0) * COLS + tl.arange(0, COLS)
        rows = tl.arange(0, ROWS)
        mask = (rows[:, None] < P) & (cols[None, :] < D)
        tile = tl.load(DWP + rows[:, None].to(tl.int64) * D + cols[None, :],
                       mask=mask, other=0.0)
        tl.store(DW + cols, tl.sum(tile, axis=0).to(DW.dtype.element_ty),
                 mask=cols < D)

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

    @triton.jit
    def swiglu_bwd(G, U, DO, DG, DU, N, ACT: tl.constexpr,
                   BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < N
        g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
        u = tl.load(U + offs, mask=mask, other=0.0).to(tl.float32)
        do = tl.load(DO + offs, mask=mask, other=0.0).to(tl.float32)
        # The activation and its closed-form derivative (_act_and_grad).
        if ACT == 0:
            sg = tl.sigmoid(g)
            val = g * sg
            dval = sg * (1.0 + g * (1.0 - sg))
        else:
            inner = 0.7978845608028654 * (g + 0.044715 * g * g * g)
            t = 2.0 * tl.sigmoid(2.0 * inner) - 1.0      # tanh(inner)
            val = 0.5 * g * (1.0 + t)
            dval = 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * \
                0.7978845608028654 * (1.0 + 3.0 * 0.044715 * g * g)
        tl.store(DG + offs, (do * u * dval).to(DG.dtype.element_ty),
                 mask=mask)
        tl.store(DU + offs, (do * val).to(DU.dtype.element_ty), mask=mask)

    return {"rms": rms_fwd, "rms_bwd": rms_bwd, "rms_dw_sum": rms_dw_sum,
            "swiglu": swiglu_fwd, "swiglu_bwd": swiglu_bwd,
            "next_pow2": triton.next_power_of_2,
            "device_properties":
                triton.runtime.driver.active.utils.get_device_properties}


def _require_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} (the kernel takes CUDA "
                         "tensors; the plain version takes CPU tensors)")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")


def _row_block(name: str, d: int) -> int:
    block = _kernels()["next_pow2"](d)
    if block > 65536:
        raise ValueError(f"{name}: hidden {d} exceeds one program's row")
    return block


def _norm_launch(x2, r2, w, eps: float, plus_one: bool):
    rows, d = x2.shape
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} != ({d},)")
    block = _row_block("rmsnorm", d)
    o = torch.empty_like(x2)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x2.device)
    y = torch.empty_like(x2) if r2 is not None else o
    num_warps = min(max(block // 512, 1), 16)
    _kernels()["rms"][(rows,)](
        x2, r2 if r2 is not None else x2, w, y, o, rstd, d, float(eps),
        HAS_RESIDUAL=r2 is not None, PLUS_ONE=bool(plus_one), BLOCK=block,
        num_warps=num_warps)
    return y, o, rstd


def _norm_fwd(x2, r2, w, eps: float, plus_one: bool, wrapper):
    """(y or None, o, rstd [T] fp32): the kernel for a CUDA tensor (counted
    on ``wrapper``), the plain version for a CPU one."""
    if x2.device.type == "cpu":
        y = x2 + r2 if r2 is not None else None
        o, rstd = _rms_ref(y if r2 is not None else x2, w, eps, plus_one)
        return y, o, rstd[:, 0]
    _require_cuda(wrapper.__name__, x2, w, *(() if r2 is None else (r2,)))
    y, o, rstd = _norm_launch(x2.contiguous(), None if r2 is None
                              else r2.contiguous(), w.contiguous(), eps,
                              plus_one)
    wrapper.launches += 1
    return (y if r2 is not None else None), o, rstd


def _swiglu_fwd(gate: torch.Tensor, up: torch.Tensor, act: str):
    """``act(gate) * up``: the kernel for a CUDA tensor (counted on
    ``swiglu_fused``), the plain version for a CPU one."""
    if gate.device.type == "cpu":
        return swiglu_ref(gate, up, act=act)
    _require_cuda("swiglu_fused", gate, up)
    g, u = gate.contiguous(), up.contiguous()
    out = torch.empty_like(g)
    n = g.numel()
    _kernels()["swiglu"][(-(-n // SWIGLU_BLOCK),)](
        g, u, out, n, ACT=_ACT_CODE[act], BLOCK=SWIGLU_BLOCK, num_warps=4)
    swiglu_fused.launches += 1
    return out


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rms_bwd_grid(rows: int, d: int, sms: int, per_sm: int):
    """Launch geometry of the RMSNorm backward over ``rows`` x ``d`` on
    ``sms`` SMs that hold ``per_sm`` row-pass programs each: (programs of
    the row pass, program p taking rows p, p + programs, ...; column strips
    of the dw sum, ``RMS_DW_COLS`` wide; rows of its tile, the programs
    rounded up to a power of two)."""
    progs = max(1, min(rows, max(1, min(per_sm, RMS_BWD_PER_SM)) * sms))
    return progs, -(-d // RMS_DW_COLS), 1 << (progs - 1).bit_length()


#: Row-pass programs per SM by (card, specialisation), from the compiled
#: kernel (``_rms_bwd_per_sm``).
_RMS_BWD_OCCUPANCY: dict[tuple, int] = {}


def _rms_bwd_per_sm(index: int, num_warps: int, args: list,
                    consts: dict) -> int:
    """Row-pass programs card ``index`` holds per SM, from the registers
    and shared memory of the kernel compiled for ``args`` (``warmup``
    compiles it without launching, into the cache the launch then uses)."""
    key = (index, num_warps, *(a.dtype for a in args[:6]),
           *sorted(consts.items()))
    per_sm = _RMS_BWD_OCCUPANCY.get(key)
    if per_sm is None:
        k = _kernels()
        kernel = k["rms_bwd"].warmup(*args, grid=(1,), num_warps=num_warps,
                                     **consts)
        kernel._init_handles()
        props = k["device_properties"](index)
        threads = 32 * num_warps
        per_sm = max(1, min(
            props["max_num_regs"] // max(kernel.n_regs * threads, 1),
            props["max_shared_mem"] // max(kernel.metadata.shared, 1),
            torch.cuda.get_device_properties(
                index).max_threads_per_multi_processor // threads))
        _RMS_BWD_OCCUPANCY[key] = per_sm
    return per_sm


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                dh: torch.Tensor, *, plus_one: bool = False,
                dy: torch.Tensor | None = None):
    """Kernel 3: RMSNorm backward over rows, x, dh (and ``dy``) [T, D],
    fp32 ``rstd`` [T] → (dx [T, D] in x's dtype, dw [D] in w's dtype)."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, rstd, dh, plus_one=plus_one, dy=dy)
    extra = () if dy is None else (dy,)
    _require_cuda("rmsnorm_bwd", x, w, rstd, dh, *extra)
    rows, d = x.shape
    if dh.shape != x.shape or (dy is not None and dy.shape != x.shape) \
            or w.shape != (d,) or rstd.numel() != rows:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)}, dh "
                         f"{tuple(dh.shape)}, w {tuple(w.shape)}, rstd "
                         f"{tuple(rstd.shape)} do not match")
    x, w, dh = x.contiguous(), w.contiguous(), dh.contiguous()
    rstd = rstd.contiguous().float()
    dy = dy.contiguous() if dy is not None else None
    block = _row_block("rmsnorm_bwd", d)
    num_warps = min(max(block // 512, 1), 16)
    k = _kernels()
    dx = torch.empty_like(x)
    args = [x, w, rstd, dh, dy if dy is not None else dh, dx]
    consts = dict(HAS_DY=dy is not None, PLUS_ONE=bool(plus_one),
                  BLOCK=block)
    index = x.device.index
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    # The occupancy probe compiles the launch's kernel before the program
    # count is known: rstd stands in for the fp32 scratch, the SM count for
    # the program count.
    per_sm = _rms_bwd_per_sm(index, num_warps,
                             [*args, rstd, rows, d, sms], consts)
    progs, strips, tile = rms_bwd_grid(rows, d, sms, per_sm)
    partial = torch.empty((progs, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((d,), dtype=w.dtype, device=x.device)
    k["rms_bwd"][(progs,)](*args, partial, rows, d, progs,
                           num_warps=num_warps, **consts)
    k["rms_dw_sum"][(strips,)](partial, dw, progs, d, ROWS=tile,
                               COLS=RMS_DW_COLS, num_warps=8)
    rmsnorm_bwd.launches += 1
    return dx, dw


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, plus_one):
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        _, o, rstd = _norm_fwd(x2, None, w, eps, plus_one, rmsnorm_fused)
        ctx.save_for_backward(x2, w, rstd)
        ctx.plus_one = plus_one
        return o.reshape(x.shape)

    @staticmethod
    def backward(ctx, dh):
        x2, w, rstd = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x2, w, rstd, dh.reshape(x2.shape),
                             plus_one=ctx.plus_one)
        return dx.reshape(dh.shape), dw, None, None


class _AddRMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, w, eps, plus_one):
        d = x.shape[-1]
        y, o, rstd = _norm_fwd(x.reshape(-1, d), res.reshape(-1, d), w, eps,
                               plus_one, add_rmsnorm_fused)
        ctx.save_for_backward(y, w, rstd)
        ctx.plus_one = plus_one
        return y.reshape(x.shape), o.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy, dh):
        y, w, rstd = ctx.saved_tensors
        # y = x + res feeds both outputs: each input's cotangent is the
        # stream's cotangent plus the norm's dx.
        dx, dw = rmsnorm_bwd(y, w, rstd, dh.reshape(y.shape),
                             plus_one=ctx.plus_one, dy=dy.reshape(y.shape))
        dx = dx.reshape(dh.shape)
        return dx, dx, dw, None, None


def rmsnorm_fused(x: torch.Tensor, w: torch.Tensor, *, eps: float,
                  plus_one: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim; ``x`` [..., D], ``w`` [D]; differentiable
    in both (kernel 3 for the backward)."""
    if not _needs_grad(x, w):
        d = x.shape[-1]
        _, o, _ = _norm_fwd(x.reshape(-1, d), None, w, float(eps),
                            bool(plus_one), rmsnorm_fused)
        return o.reshape(x.shape)
    return _RMSNormFn.apply(x, w, float(eps), bool(plus_one))


def add_rmsnorm_fused(x: torch.Tensor, res: torch.Tensor, w: torch.Tensor,
                      *, eps: float, plus_one: bool = False):
    """``y = x + res; h = rmsnorm(y)`` in one pass; returns ``(y, h)``."""
    if x.shape != res.shape or x.dtype != res.dtype:
        raise ValueError(f"add_rmsnorm: x {tuple(x.shape)}/{x.dtype} vs "
                         f"res {tuple(res.shape)}/{res.dtype}")
    if not _needs_grad(x, res, w):
        d = x.shape[-1]
        y, o, _ = _norm_fwd(x.reshape(-1, d), res.reshape(-1, d), w,
                            float(eps), bool(plus_one), add_rmsnorm_fused)
        return y.reshape(x.shape), o.reshape(x.shape)
    return _AddRMSNormFn.apply(x, res, w, float(eps), bool(plus_one))


def _check_pair(gate: torch.Tensor, up: torch.Tensor, act: str) -> None:
    if gate.shape != up.shape or gate.dtype != up.dtype:
        raise ValueError(f"gate {tuple(gate.shape)}/{gate.dtype} != "
                         f"up {tuple(up.shape)}/{up.dtype}")
    if act not in _ACT_CODE:
        raise ValueError(f"unknown activation {act!r}")


def swiglu_bwd(gate: torch.Tensor, up: torch.Tensor, do: torch.Tensor, *,
               act: str = "silu"):
    """Kernel 5: (dgate, dup) of ``act(gate) * up`` for the cotangent
    ``do``, all [..., M]."""
    _check_pair(gate, up, act)
    if do.shape != gate.shape:
        raise ValueError(f"swiglu_bwd: do {tuple(do.shape)} != "
                         f"{tuple(gate.shape)}")
    if gate.device.type == "cpu":
        return swiglu_bwd_ref(gate, up, do, act=act)
    _require_cuda("swiglu_bwd", gate, up, do)
    g, u, d = gate.contiguous(), up.contiguous(), do.contiguous()
    dg, du = torch.empty_like(g), torch.empty_like(u)
    n = g.numel()
    _kernels()["swiglu_bwd"][(-(-n // SWIGLU_BLOCK),)](
        g, u, d, dg, du, n, ACT=_ACT_CODE[act], BLOCK=SWIGLU_BLOCK,
        num_warps=4)
    swiglu_bwd.launches += 1
    return dg, du


class _SwiGLUFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up, act):
        ctx.save_for_backward(gate, up)
        ctx.act = act
        return _swiglu_fwd(gate, up, act)

    @staticmethod
    def backward(ctx, do):
        gate, up = ctx.saved_tensors
        dg, du = swiglu_bwd(gate, up, do, act=ctx.act)
        return dg, du, None


def swiglu_fused(gate: torch.Tensor, up: torch.Tensor, *,
                 act: str = "silu") -> torch.Tensor:
    """``act(gate) * up`` over matching [..., M] inputs (silu → SwiGLU,
    gelu → GeGLU); differentiable in both (kernel 5 for the backward)."""
    _check_pair(gate, up, act)
    if not _needs_grad(gate, up):
        return _swiglu_fwd(gate, up, act)
    return _SwiGLUFn.apply(gate, up, act)


rmsnorm_fused.launches = 0
add_rmsnorm_fused.launches = 0
swiglu_fused.launches = 0
rmsnorm_bwd.launches = 0
swiglu_bwd.launches = 0
