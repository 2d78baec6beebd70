"""Model storage: resolve a ``storageUri`` to decoder params before serving
(port of ``kubeflow_tpu/serve/storage.py``; the storage-initializer
analog), and the remote KV tier's store (``kv_fabric_store``).

Schemes:

- ``file:///dir`` — a checkpoint directory in the port's own format
  (``train/checkpoint.py``: one ``.pt`` per tensor, a manifest per step),
  as a port ``Trainer`` writes it. The JAX package reads orbax
  checkpoints here; the port reads no orbax (a JAX-trained tree comes
  across through ``models.convert.params_from_jax`` and a port save).
- ``artifact://<digest>``, ``artifact://<name>@<version>``,
  ``artifact://<name>`` — a tree in the platform's artifact store
  (``pipelines/artifacts.py``, rooted at ``artifact_root`` or
  ``$KFTPU_ARTIFACT_ROOT``), materialized content-addressed and then read
  as ``file://`` reads a directory: the tree must be a port checkpoint.
- ``random://`` (or no URI) — fresh random weights from ``seed``, for
  load tests and smoke runs.

A missing or unreadable checkpoint raises; random weights never stand in
for it.
"""

from __future__ import annotations

import os
from typing import Optional
from urllib.parse import urlparse

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.models.decoder import Params, init_decoder_params
from kubeflow_tpu_torch.pipelines.artifacts import (
    ArtifactStore, artifact_store_from_env,
)

#: What ``file://`` expects to find, named in its errors.
FILE_FORMAT = ("a kubeflow_tpu_torch checkpoint directory (train/"
               "checkpoint.py: <dir>/<step>/meta.json and one .pt per tensor)")


def load_params(storage_uri: Optional[str], cfg: DecoderConfig, *,
                seed: int = 0,
                artifact_root: Optional[str] = None,
                device: str | torch.device = "cuda") -> Params:
    """Resolve ``storage_uri`` into a decoder param tree on ``device``.

    file:///path — the latest step's ``params`` subtree of a port
    checkpoint directory, verified against its manifest, cast to
    ``cfg.param_dtype``.
    artifact://<digest> | artifact://<name>[@<version>] — a published
    tree in the artifact store (``artifact_root`` or
    ``$KFTPU_ARTIFACT_ROOT``), materialized content-addressed, so replicas
    and restarts share one layout; then read as ``file://`` reads it.
    random:// or None — ``init_decoder_params`` from a generator on
    ``device`` seeded with ``seed``: the same weights as an engine built
    with that seed and ``weights_dtype`` equal to ``cfg.param_dtype``."""
    dev = resolve_device(device)
    if storage_uri is None or storage_uri.startswith("random://"):
        return init_decoder_params(torch.Generator(dev).manual_seed(seed),
                                   cfg)
    parsed = urlparse(storage_uri)
    if parsed.scheme == "file":
        return _load_checkpoint(parsed.path, cfg, dev)
    if parsed.scheme == "artifact":
        store = artifact_store_from_env(artifact_root)
        ckpt_dir = store.materialize_tree(store.resolve(storage_uri))
        return _load_checkpoint(ckpt_dir, cfg, dev)
    raise ValueError(
        f"unsupported storageUri scheme {parsed.scheme!r} "
        "(hermetic build: file://, artifact:// and random:// only)")


def _load_checkpoint(path: str, cfg: DecoderConfig,
                     device: torch.device) -> Params:
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    # CheckpointManager creates its directory: a missing one must not be
    # made (and then read as empty) by a server.
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"no checkpoint directory at {path}; expected {FILE_FORMAT}")
    mgr = CheckpointManager(path)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(
            f"no checkpoint steps under {path}; expected {FILE_FORMAT}")
    if not os.path.exists(os.path.join(path, str(step), "meta.json")):
        raise FileNotFoundError(
            f"step {step} under {path} has no meta.json: not a port "
            "checkpoint (an orbax checkpoint, as the JAX trainer writes "
            "it, comes across through models.convert.params_from_jax and "
            f"a port save); expected {FILE_FORMAT}")
    params = mgr.restore(step, device=device, subtree="params")
    dt = cfg.weight_dtype
    return T.map_tree(lambda t: t.to(dt) if t.is_floating_point() else t,
                      params)


def kv_fabric_store(root: Optional[str] = None) -> Optional[ArtifactStore]:
    """The remote KV tier's store, or None when the tier is off.
    Resolution order: explicit ``root`` (``BatchingSpec.remote_kv_root``),
    then ``$KFTPU_KV_REMOTE_ROOT``. Deliberately separate from
    ``$KFTPU_ARTIFACT_ROOT``: KV spill blobs are high-churn ephemera, and
    sharing the model store would let its GC sweeps race serving traffic.
    The same ``ArtifactStore`` type, though: content-addressed blobs (the
    digest is the checksum a promotion verifies) and a registry that
    survivors probe by chain key."""
    root = root or os.environ.get("KFTPU_KV_REMOTE_ROOT") or None
    if not root:
        return None
    return ArtifactStore(root)
