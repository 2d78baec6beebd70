"""The ``model_server`` worker entrypoint: what an InferenceService predictor
replica runs (port of ``kubeflow_tpu/serve/model_server.py``; the
kserve-container and storage-initializer pair in one process).

Config (``KFTPU_CONFIG_JSON``):
    model:       {"preset": str, "overrides": {...}}  decoder architecture
    storage_uri: str | None                           weights (serve/storage.py)
    batching:    BatchingSpec fields                  engine knobs
    port:        int                                  HTTP port (pre-assigned)
    service:     str                                  exposed model name
    transformer: {"handler": str, "config": {...}}    pre/post hop
    explainer:   {"handler": str, "config": {...}}    :explain hop
    tokenizer:   str                                  registered name or
                                                      "module:factory"
                                                      (default "byte")

It runs ``preset`` → ``load_params`` (packing int8 weights as they load
when ``batching.quantize`` asks) → ``LLMEngine`` → ``ModelServer`` on
the worker's device (``WorkerContext.device``: the card unless
``KFTPU_PLATFORM=cpu``) and serves until SIGTERM (exit 143 through
``runtime/worker_main.py``).

A gang of N processes with ``parallelism {model: N}`` is one
tensor-parallel engine, one process per card: each rank loads only its
shards (``load_params(..., mesh=)``); rank 0 serves REST and gRPC and
runs the scheduler, the other ranks run the ops it dispatches
(``LLMEngine.follow``) until it stops. SIGTERM to rank 0 stops the
engine, which releases the followers (they exit 0); a follower's death
fails rank 0's next dispatch or idle ping, and the worker exits
nonzero. The gang serves in every ``batching.role`` and with the host
and remote KV tiers (only rank 0 keeps a tier and relays handoffs), and
answers ``:explain`` with every rank computing on its shards
(``LLMEngine.explain``). Other parallelisms raise under a mesh, as the JAX
package's ``PredictorSpec`` refuses them (ROADMAP.md Queue 1 item 9e2).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable

from kubeflow_tpu_torch.runtime.entrypoints import (
    WorkerContext, register_entrypoint, resolve_handler,
)

logger = logging.getLogger(__name__)

#: Named transformer handlers (the "registered name" form of
#: TransformerSpec.handler; the alternative is "module:function").
transformer_registry: dict[str, Callable] = {}


def register_transformer(name: str):
    def deco(fn: Callable) -> Callable:
        transformer_registry[name] = fn
        return fn
    return deco


def resolve_transformer(handler: str) -> Callable:
    return resolve_handler(handler, transformer_registry, "transformer")


@register_transformer("strip")
def strip(text: str, phase: str) -> str:
    """Trims surrounding whitespace from the prompt and the output."""
    return text.strip()


@register_entrypoint("model_server")
def model_server(ctx: WorkerContext) -> int:
    import dataclasses
    import functools

    from kubeflow_tpu_torch.core.serving import BatchingSpec
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.serve.engine import LLMEngine
    from kubeflow_tpu_torch.serve.explain import build_explainer
    from kubeflow_tpu_torch.serve.server import ModelServer
    from kubeflow_tpu_torch.serve.storage import load_params
    from kubeflow_tpu_torch.serve.tokenizer import tokenizer_registry

    conf = ctx.config
    mesh = None
    if ctx.env.num_processes > 1 or ctx.env.parallelism:
        par = {a: int(n) for a, n in (ctx.env.parallelism or {}).items()
               if int(n) > 1}
        if par != {"model": ctx.env.num_processes}:
            raise NotImplementedError(
                f"num_processes={ctx.env.num_processes}, parallelism="
                f"{ctx.env.parallelism}: a model_server gang is one "
                "tensor-parallel engine, parallelism {model: "
                "num_processes}; other serving meshes arrive with "
                "ROADMAP.md Queue 1 item 9e2")
        mesh = ctx.mesh
    model_conf = conf.get("model", {})
    cfg = preset(model_conf.get("preset", "tiny"),
                 **model_conf.get("overrides", {}))
    batching_conf = dict(conf.get("batching", {}))
    known = {f.name for f in dataclasses.fields(BatchingSpec)}
    unknown = sorted(set(batching_conf) - known)
    if unknown:
        raise ValueError(f"batching fields {unknown} are not in the port's "
                         f"BatchingSpec; known: {sorted(known)}")
    device = ctx.device
    if device.startswith("cuda"):
        # Kernels are built before the first request, not inside it; a
        # checkout whose csrc/build already holds them loads them as is.
        from kubeflow_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.build_all()
        logger.info("CUDA kernels ready in %.2f s (compiled here: %s)",
                    time.perf_counter() - t0,
                    ", ".join(sorted(_build.PTXAS)) or "none")
    batching = BatchingSpec(**batching_conf)
    load_cfg = cfg
    if batching.quantize and batching.weights_dtype:
        # The engine quantizes after its weights_dtype cast; a quantized
        # load packs as it loads, so it casts first.
        load_cfg = dataclasses.replace(cfg,
                                       param_dtype=batching.weights_dtype)
    params = load_params(conf.get("storage_uri"), load_cfg, device=device,
                         quantize=batching.quantize, mesh=mesh)
    engine = LLMEngine(cfg, batching, params=params, device=device,
                       mesh=mesh)
    del params
    if engine.tp is not None and engine.tp.rank > 0:
        n = engine.follow()
        logger.info("follower rank %d ran %d ops (by op %s)%s",
                    engine.tp.rank, n,
                    json.dumps(dict(engine._dispatch.by_op)),
                    _memory_note(device))
        return 0
    transformer = None
    t_conf = conf.get("transformer")
    if t_conf:
        # kserve-transformer analog: fn(text, phase, **config).
        transformer = resolve_transformer(t_conf["handler"])
        if t_conf.get("config"):
            transformer = functools.partial(transformer, **t_conf["config"])
    tokenizer = resolve_handler(conf.get("tokenizer", "byte"),
                                tokenizer_registry, "tokenizer")()
    server = ModelServer(conf.get("service", "model"), engine,
                         tokenizer=tokenizer, transformer=transformer,
                         explainer=build_explainer(conf.get("explainer")),
                         port=int(conf["port"]))
    server.start()
    logger.info("serving %s (%s, %s) on port %d%s", server.name,
                model_conf.get("preset", "tiny"), device, server.port,
                _memory_note(device))
    try:
        while True:          # serve until SIGTERM (exit 143 via worker_main)
            time.sleep(0.5)
            if engine.error is not None:
                raise RuntimeError("the engine's scheduler stopped") \
                    from engine.error
    finally:
        server.stop()
        ops = ("" if engine.tp is None else
               f"; {engine.dispatches} ops dispatched to the model axis "
               f"({engine._dispatch.send_s * 1e3:.3f} ms sending; by op "
               f"{json.dumps(dict(engine._dispatch.by_op))}; bytes each "
               f"follower received by op "
               f"{json.dumps(dict(engine._dispatch.bytes_by_op))})")
        logger.info("model server stopped%s%s", ops, _memory_note(device))
    return 0


def _memory_note(device: str) -> str:
    """The card's allocated and peak allocated bytes, for the log."""
    if not device.startswith("cuda"):
        return ""
    import torch

    peak = torch.cuda.max_memory_allocated()
    return (f"; device memory {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB allocated, peak {peak / 2**30:.2f} GiB ({peak} bytes)")
