"""Pipeline parallelism: microbatches streamed through the stages of the
``pipeline`` mesh axis (port of ``kubeflow_tpu/parallel/pipeline.py``).

The JAX package runs every stage in one SPMD program (``shard_map`` over
the axis, activations hopping by ``ppermute`` inside a ``lax.scan``);
here each stage is a process of its own, and the schedule is what each
stage does in turn: run a microbatch forward, run one backward, and
exchange activations and cotangents with its neighbours. A stage's
schedule is a generator (``stage_program``) that yields a ``Comm`` at
every exchange and is sent what it received, so one schedule runs on
two runners:

- ``run_lockstep``: every stage in one process, the exchanges through
  mailboxes (the CPU tests and the one-card chip check);
- ``run_stage``: this process's stage, the exchanges through
  point-to-point calls over the pipeline group (``collectives.exchange``:
  NCCL on the cards, gloo on the CPU), a send and a receive of the same
  tick in one batch, so two neighbours that send each other a tensor in
  the same tick cannot deadlock.

Two schedules, as in the JAX package:

- ``"gpipe"``: every microbatch forward, then every microbatch backward
  (in the same order); a stage keeps each microbatch's stage input until
  its backward (its activations too, unless ``checkpoint_stages``
  recomputes them there).
- ``"1f1b"``: PyTorch's usual one-forward-one-backward schedule: stage s
  runs ``n - 1 - s`` warm-up forwards, then alternates one forward and
  one backward, then the cool-down backwards, so at most ``n - s``
  microbatches are in flight on it, whatever m. It does not need JAX's
  ring-buffer recompute lane (3 forwards + 1 backward a microbatch); its
  gradients are the same sums, accumulated in the same microbatch order
  as GPipe's.

The automatic microbatch count is JAX's exactly: the largest m ≤ 2·n
(GPipe) or ≤ 4·n (1F1B) that divides the local batch (``microbatches``).

A stage's work (``Stage``) is one function of its params and the streamed
tensors, which keeps their number and shapes (the transformer-stack
contract). The first stage's input comes from ``feed(i)``; the last
stage's output goes to ``sink(i, ys)``, which returns what its backward
starts from (a loss, or the output and its cotangent). Gradients are
taken microbatch by microbatch with ``torch.autograd.grad`` and summed
into the stage's param gradients, so the step's gradients exist when the
schedule ends. ``pipeline_apply`` wraps this as an autograd function of
the stacked stage params (the JAX function's counterpart, in lockstep):
its forward streams the microbatches, its backward runs the chosen
schedule again with the output cotangents, recomputing each stage's
forward.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from contextlib import nullcontext
from typing import Any, Callable, Iterator, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.train import tree as T

StageFn = Callable[[Any, Any], Any]
SCHEDULES = ("gpipe", "1f1b")


def stack_stage_params(per_stage: list[Any]) -> Any:
    """[stage0_tree, stage1_tree, ...] → one tree with a leading stage
    dim."""
    return T.unflatten({p: torch.stack([T.flatten(t)[p] for t in per_stage])
                        for p in T.flatten(per_stage[0])})


def sequential_apply(stage_fn: StageFn, stage_params: Any, xs: Any) -> Any:
    """Numerics oracle: the same stages, no pipelining."""
    n = T.leaves(stage_params)[0].shape[0]
    for i in range(n):
        xs = stage_fn(T.map_tree(lambda p: p[i], stage_params), xs)
    return xs


def check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")


def microbatches(batch: int, data_shards: int, n_stages: int,
                 schedule: str, num_microbatches: Optional[int] = None
                 ) -> int:
    """The microbatch count of a global ``batch`` split over
    ``data_shards``: ``num_microbatches``, or the largest m ≤ 2·n (GPipe)
    or ≤ 4·n (1F1B) that divides the local batch; a batch that does not
    divide raises JAX's ``ValueError``."""
    check_schedule(schedule)
    local = batch // data_shards
    m = num_microbatches
    if m is None:
        cap = (4 if schedule == "1f1b" else 2) * n_stages
        m = next((k for k in range(min(cap, max(local, 1)), 0, -1)
                  if local % k == 0), 1)
    if batch % data_shards or local % m:
        raise ValueError(
            f"batch {batch} must be divisible by data shards {data_shards} "
            f"× num_microbatches {m}")
    return m


@dataclasses.dataclass
class Comm:
    """One exchange of a stage's schedule: ``tensors`` sent to the
    ``send`` neighbour ("next" or "prev"), and a receive from the ``recv``
    neighbour, in one batch. The schedule is sent what it received."""

    send: Optional[str] = None
    tensors: Sequence[torch.Tensor] = ()
    recv: Optional[str] = None


def _comm(send: Optional[str], tensors, recv: Optional[str]):
    """Yield one ``Comm`` (nothing when it has neither side); returns what
    was received."""
    if send is None and recv is None:
        return None
    return (yield Comm(send, tensors or (), recv))


def stage_program(stage: int, n: int, m: int, schedule: str,
                  forward: Callable, backward: Optional[Callable] = None
                  ) -> Iterator[Comm]:
    """Stage ``stage`` of ``n``'s schedule over ``m`` microbatches:
    ``forward(i, received)`` returns the tensors to send on (None on the
    last stage), ``backward(i, received)`` the cotangents to send back
    (None on the first). Without ``backward`` the forwards alone (the
    GPipe order)."""
    check_schedule(schedule)
    first, last = stage == 0, stage == n - 1
    fsend, frecv = (None if last else "next"), (None if first else "prev")
    bsend, brecv = (None if first else "prev"), (None if last else "next")
    if backward is None or schedule == "gpipe":
        for i in range(m):
            x = yield from _comm(None, None, frecv)
            y = forward(i, x)
            yield from _comm(fsend, y, None)
        if backward is None:
            return
        for i in range(m):
            g = yield from _comm(None, None, brecv)
            yield from _comm(bsend, backward(i, g), None)
        return
    warm = min(n - 1 - stage, m)
    for i in range(warm):
        x = yield from _comm(None, None, frecv)
        yield from _comm(fsend, forward(i, x), None)
    steady = m - warm
    if steady:
        x = yield from _comm(None, None, frecv)
    for j in range(steady):
        y = forward(warm + j, x)
        g = yield from _comm(fsend, y, brecv)
        dx = backward(j, g)
        if j == steady - 1:
            yield from _comm(bsend, dx, None)
        else:
            x = yield from _comm(bsend, dx, frecv)
    for i in range(steady, m):
        g = yield from _comm(None, None, brecv)
        yield from _comm(bsend, backward(i, g), None)


def run_lockstep(programs: list, around: Optional[Callable] = None) -> None:
    """Every stage's program in this process: each runs until it waits for
    a tensor no stage has sent yet, then the next; messages on one
    channel arrive in the order they were sent. ``around(stage)`` (a
    context manager) is entered around each stretch of a stage's work. A
    schedule whose stages all wait raises."""
    n = len(programs)
    boxes: dict = {}
    wants: list = [None] * n        # the channel a stage waits on
    done = [False] * n

    def deliver(s: int, c: Comm) -> None:
        if c.send is not None:
            to = s + 1 if c.send == "next" else s - 1
            frm = "prev" if c.send == "next" else "next"
            boxes.setdefault((to, frm), deque()).append(list(c.tensors))

    while not all(done):
        moved = False
        for s, prog in enumerate(programs):
            if done[s]:
                continue
            value = None
            if wants[s] is not None:
                box = boxes.get((s, wants[s]))
                if not box:
                    continue
                value, wants[s] = box.popleft(), None
            moved = True
            with (around(s) if around is not None else nullcontext()):
                while True:
                    try:
                        c = prog.send(value)
                    except StopIteration:
                        done[s] = True
                        break
                    deliver(s, c)
                    value = None
                    if c.recv is not None:
                        box = boxes.get((s, c.recv))
                        if not box:
                            wants[s] = c.recv
                            break
                        value = box.popleft()
        if not moved:
            raise RuntimeError("pipeline schedule deadlocked: every stage "
                               "waits for a tensor")


def run_stage(program: Iterator[Comm], link) -> None:
    """This process's stage: each ``Comm`` through ``link.exchange``
    (``PipeLink``)."""
    value = None
    while True:
        try:
            c = program.send(value)
        except StopIteration:
            return
        value = link.exchange(c)


class PipeLink:
    """This process's neighbours on the pipeline axis
    (``collectives.PipelineAxis``) and the streamed tensors' shapes and
    dtypes (``template``: a cotangent has its activation's)."""

    def __init__(self, axis, template: Sequence[tuple], device):
        self.axis, self.template, self.device = axis, list(template), device

    def exchange(self, c: Comm) -> Optional[list[torch.Tensor]]:
        from kubeflow_tpu_torch.parallel.collectives import exchange

        return exchange(self.axis, c.send, c.tensors, c.recv,
                        self.template, self.device)


class Stage:
    """One stage's work for ``stage_program``: ``fn(params, xs) -> ys``
    on this stage's ``params`` (a tree; ``leaves`` the tensors whose
    gradients it sums), the first stage's ``feed(i) -> xs``, the last
    stage's ``sink(i, ys) -> (outputs, cotangents or None)`` that its
    backward starts from (called with or without ``grad``).
    ``checkpoint_stages`` recomputes the stage's forward in its backward.
    With ``grad`` false the forwards keep nothing."""

    def __init__(self, fn: StageFn, params: Any, *, stage: int, n: int,
                 feed: Optional[Callable] = None,
                 sink: Optional[Callable] = None,
                 leaves: Optional[list] = None, grad: bool = True,
                 checkpoint_stages: bool = True):
        self.fn, self.params = fn, params
        self.first, self.last = stage == 0, stage == n - 1
        self.feed, self.sink = feed, sink
        self.leaves = list(leaves if leaves is not None
                           else T.leaves(params))
        self.grad = grad
        self.checkpoint = checkpoint_stages and grad
        #: The summed gradient of each of ``leaves`` (None: no use yet).
        self.grads: list = [None] * len(self.leaves)
        #: The first stage's input cotangents by microbatch (the inputs
        #: ``feed`` gave as tensors that require a gradient).
        self.input_grads: dict[int, list] = {}
        self._saved: dict[int, tuple] = {}

    def _run(self, xs: list) -> list:
        if self.checkpoint:
            return list(checkpoint(lambda *a: tuple(self.fn(self.params,
                                                             list(a))),
                                   *xs, use_reentrant=False))
        return list(self.fn(self.params, xs))

    def forward(self, i: int, received) -> Optional[list]:
        with torch.set_grad_enabled(self.grad):
            if self.first:
                xs = list(self.feed(i))
            else:
                xs = [t.requires_grad_(self.grad and t.is_floating_point())
                      for t in received]
            ys = self._run(xs)
            if self.last:
                outs, cots = self.sink(i, ys)
                if self.grad:
                    self._saved[i] = (xs, outs, cots)
                return None
            if self.grad:
                self._saved[i] = (xs, ys, None)
            return [y.detach() for y in ys]

    def backward(self, i: int, received) -> Optional[list]:
        xs, outs, cots = self._saved.pop(i)
        if not self.last:
            cots = received
        at = [k for k, x in enumerate(xs) if x.requires_grad and x.is_leaf]
        ins = [xs[k] for k in at]
        pairs = [(o, c) for o, c in zip(outs, cots if cots is not None
                                        else [None] * len(outs))
                 if o.requires_grad]
        got = torch.autograd.grad(
            [o for o, _ in pairs], self.leaves + ins,
            [c for _, c in pairs] if cots is not None else None,
            allow_unused=True)
        for k, g in enumerate(got[:len(self.leaves)]):
            if g is not None:
                self.grads[k] = g if self.grads[k] is None \
                    else self.grads[k] + g
        dxs: list = [None] * len(xs)
        for k, g in zip(at, got[len(self.leaves):]):
            dxs[k] = g
        if self.first:
            self.input_grads[i] = dxs
            return None
        return [torch.zeros_like(x) if d is None else d
                for x, d in zip(xs, dxs)]


class _PipelineApply(torch.autograd.Function):
    """``pipeline_apply``'s autograd function over the flat stage params
    and streamed leaves: the forward streams the microbatches (forwards
    only), the backward runs the schedule with the output cotangents."""

    @staticmethod
    def forward(ctx, run, n_params, *flat):
        ctx.run, ctx.n_params = run, n_params
        ctx.save_for_backward(*flat)
        with torch.no_grad():
            return tuple(run(list(flat[:n_params]), list(flat[n_params:]),
                             None))

    @staticmethod
    def backward(ctx, *gys):
        flat = ctx.saved_tensors
        params, xs = list(flat[:ctx.n_params]), list(flat[ctx.n_params:])
        dparams, dxs = ctx.run(params, xs, list(gys))
        return (None, None, *dparams, *dxs)


def pipeline_apply(stage_fn: StageFn, stage_params: Any, xs: Any, *,
                   n_stages: Optional[int] = None,
                   num_microbatches: Optional[int] = None,
                   schedule: str = "gpipe",
                   checkpoint_stages: bool = True,
                   around: Optional[Callable] = None) -> Any:
    """``y = stage_{n-1}(... stage_0(xs))`` pipelined over microbatches,
    every stage in this process (``run_lockstep``). ``stage_fn(params,
    xs_mb) -> ys_mb`` keeps the tree's structure and leaf shapes; every
    leaf of ``xs`` streams with its batch dim cut into the microbatches;
    the leaves of ``stage_params`` have a leading stage dim. Returns the
    same tree, [batch, ...] per leaf, differentiable with respect to the
    stage params and ``xs``: the backward runs ``schedule`` (stage by
    stage, recomputing each stage's forward)."""
    p_paths = list(T.flatten(stage_params))
    p_flat = [T.flatten(stage_params)[p] for p in p_paths]
    x_paths = list(T.flatten(xs))
    x_flat = [T.flatten(xs)[p] for p in x_paths]
    n = n_stages or p_flat[0].shape[0]
    batch = x_flat[0].shape[0]
    m = microbatches(batch, 1, n, schedule, num_microbatches)
    mb = batch // m

    def tree_fn(params, leaves):
        out = stage_fn(params, T.unflatten(dict(zip(x_paths, leaves))))
        flat = T.flatten(out)
        return [flat[p] for p in x_paths]

    def run(params: list, leaves: list, gys: Optional[list]):
        grad = gys is not None
        stages, outputs = [], {}
        for s in range(n):
            ps = T.unflatten({p: (t[s].detach().requires_grad_(grad))
                              for p, t in zip(p_paths, params)})

            def feed(i):
                return [x[i * mb:(i + 1) * mb].detach().requires_grad_(
                    grad and x.is_floating_point()) for x in leaves]

            def sink(i, ys):
                if not grad:
                    outputs[i] = ys
                    return ys, None
                return ys, [g[i * mb:(i + 1) * mb] for g in gys]

            stages.append(Stage(tree_fn, ps, stage=s, n=n, feed=feed,
                                sink=sink, grad=grad,
                                checkpoint_stages=checkpoint_stages))
        run_lockstep([stage_program(s, n, m, schedule, st.forward,
                                    st.backward if grad else None)
                      for s, st in enumerate(stages)], around)
        if not grad:
            return [torch.cat([outputs[i][k] for i in range(m)])
                    for k in range(len(leaves))]
        dparams = [torch.stack([torch.zeros_like(t[s]) if g is None else g
                                for s, g in enumerate(
                                    st.grads[k] for st in stages)])
                   for k, t in enumerate(params)]
        first = stages[0].input_grads
        dxs = [torch.cat([torch.zeros_like(x[:mb]) if first[i][k] is None
                          else first[i][k] for i in range(m)])
               if x.is_floating_point() else None
               for k, x in enumerate(leaves)]
        return dparams, dxs

    ys = _PipelineApply.apply(run, len(p_flat), *p_flat, *x_flat)
    return T.unflatten(dict(zip(x_paths, ys)))
