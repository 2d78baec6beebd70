"""Carry a JAX-layout parameter tree into the port as torch tensors.

``params_from_jax`` takes the tree ``kubeflow_tpu.models.decoder.
init_decoder_params`` returns, already converted to numpy (``np.asarray``
per leaf — this module imports no JAX), and keeps every key and layout:
``embed [V,D]``, ``layers.attn.wq [L,D,H,Dh]``, ``wk/wv [L,D,K,Dh]``,
``wo [L,H,Dh,D]``, ``layers.mlp.gate/up [L,D,M]``, ``down [L,M,D]``,
``layers.ln1/ln2 [L,D]``, ``final_norm [D]`` and ``lm_head [D,V]``. A
list-of-blocks ``layers`` (the JAX ``scan_layers=False`` layout) is stacked
into the ``[L, ...]`` layout the port's forward walks.

``opt_state_from_jax`` does the same for an optimizer state: the optax
chain state of ``kubeflow_tpu.train.optim.make_optimizer`` (its
``ScaleByAdamState`` count, mu and nu and its schedule count, or the SGD
``TraceState``) or the ``FusedAdamW`` dict, to the dict the port's
``train/optim.py`` keeps. With both, one step from the same state can be
compared across the two packages.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    # A private copy: the source may be read-only memory its framework owns.
    arr = np.array(a, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: reinterpret the 16-bit payload.
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _stack(blocks: list) -> Any:
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack([np.asarray(b) for b in blocks])


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def params_from_jax(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Nested dict of numpy arrays (JAX layout) → nested dict of tensors on
    ``device``, same keys and shapes."""
    dev = resolve_device(device)
    tree = dict(tree)
    if isinstance(tree.get("layers"), list):
        tree["layers"] = _stack(tree["layers"])
    return _convert(tree, dev)


def _walk(state: Any):
    """Every named-tuple node of an optax chain state (depth first)."""
    if hasattr(state, "_fields"):
        yield state
        for x in state:
            yield from _walk(x)
    elif isinstance(state, (tuple, list)):
        for x in state:
            yield from _walk(x)


def opt_state_from_jax(state: Any, device: str | torch.device = "cuda") -> dict:
    """An optimizer state of the JAX package, converted to numpy leaf by
    leaf (``jax.tree.map(np.asarray, state)`` keeps the named tuples) →
    the port's ``{"count", "mu", "nu"}`` (Adam kinds, fused or chained) or
    ``{"count", "trace"}`` (SGD)."""
    if isinstance(state, dict):                      # FusedAdamW
        return {"count": int(np.asarray(state["count"])),
                "mu": params_from_jax(state["mu"], device),
                "nu": params_from_jax(state["nu"], device)}
    nodes = list(_walk(state))
    adam = [n for n in nodes if {"count", "mu", "nu"} <= set(n._fields)]
    trace = [n for n in nodes if "trace" in n._fields]
    sched = [n for n in nodes if tuple(n._fields) == ("count",)]
    if len(sched) != 1 or len(adam) + len(trace) != 1:
        raise ValueError("not an optax chain of clip + adamw/adam/sgd: "
                         f"{[type(n).__name__ for n in nodes]}")
    count = int(np.asarray(sched[0].count))
    if adam:
        if int(np.asarray(adam[0].count)) != count:
            raise ValueError("adam and schedule counts differ")
        return {"count": count, "mu": params_from_jax(adam[0].mu, device),
                "nu": params_from_jax(adam[0].nu, device)}
    return {"count": count, "trace": params_from_jax(trace[0].trace, device)}
