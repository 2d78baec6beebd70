"""Model storage: resolve a ``storageUri`` to decoder params before serving
(port of ``kubeflow_tpu/serve/storage.py``; the storage-initializer
analog), and the remote KV tier's store (``kv_fabric_store``).

Schemes:

- ``file:///dir`` — a checkpoint directory in the port's own format
  (``train/checkpoint.py``: one ``.bin`` per tensor, a manifest per step),
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
for it. ``quantize="int8"`` packs the matmul weights as they arrive (each
layer as it is drawn, each restored leaf as it lands on the device), so
the full-dtype tree is never on the card.
"""

from __future__ import annotations

import os
from typing import Optional
from urllib.parse import urlparse

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.config import DecoderConfig
from kubeflow_tpu_torch.models.decoder import (
    Params, decoder_layout, init_decoder_params,
)
from kubeflow_tpu_torch.ops.quantization import check_quantize, quantize_leaf
from kubeflow_tpu_torch.pipelines.artifacts import (
    ArtifactStore, artifact_store_from_env,
)

#: What ``file://`` expects to find, named in its errors.
FILE_FORMAT = ("a kubeflow_tpu_torch checkpoint directory (train/"
               "checkpoint.py: <dir>/<step>/meta.json and one .bin per "
               "tensor)")


def load_params(storage_uri: Optional[str], cfg: DecoderConfig, *,
                seed: int = 0,
                artifact_root: Optional[str] = None,
                device: str | torch.device = "cuda",
                quantize: Optional[str] = None,
                mesh=None) -> Params:
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
    with that seed and ``weights_dtype`` equal to ``cfg.param_dtype``.

    ``quantize="int8"``: the tree ``quantize_params_int8`` would make of the
    full-dtype one, bit for bit, built leaf by leaf.

    ``mesh`` (a tensor-parallel engine's): this rank's shards of that
    tree, by the training rules (``decoder_param_specs``). A random draw
    keeps each leaf's block as it is drawn; a checkpoint is read in the
    rank's slices of each leaf file — except under ``quantize``, which
    reads a leaf whole (one at a time) for its per-channel scales and
    then cuts it. The whole model is never held at once."""
    check_quantize(quantize)
    dev = resolve_device(device)
    if storage_uri is None or storage_uri.startswith("random://"):
        cut = None if mesh is None else decoder_layout(cfg, mesh).cut_leaf
        return init_decoder_params(
            torch.Generator(dev).manual_seed(seed), cfg, quantize=quantize,
            shard=cut)
    parsed = urlparse(storage_uri)
    if parsed.scheme == "file":
        return _load_checkpoint(parsed.path, cfg, dev, quantize, mesh)
    if parsed.scheme == "artifact":
        store = artifact_store_from_env(artifact_root)
        ckpt_dir = store.materialize_tree(store.resolve(storage_uri))
        return _load_checkpoint(ckpt_dir, cfg, dev, quantize, mesh)
    raise ValueError(
        f"unsupported storageUri scheme {parsed.scheme!r} "
        "(hermetic build: file://, artifact:// and random:// only)")


def _load_checkpoint(path: str, cfg: DecoderConfig, device: torch.device,
                     quantize: Optional[str] = None, mesh=None) -> Params:
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointManager, ShardLayout,
    )

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
    dt = cfg.weight_dtype
    params_layout = None if mesh is None else decoder_layout(cfg, mesh)
    layout = None
    if mesh is not None and quantize is None:
        layout = ShardLayout(params_layout.sizes, params_layout.coords, {
            f"params/{p}": s for p, s in params_layout.flat_specs.items()})

    def leaf(path: str, t: torch.Tensor):
        # Read to host, then onto the device one leaf at a time, cast, and
        # packed there when quantizing.
        t = t.to(device)
        if t.is_floating_point():
            t = t.to(dt)
        if quantize is not None:
            t = quantize_leaf(tuple(path.split("/")), t, cfg)
            if params_layout is not None:
                t = params_layout.cut_leaf(path, t)
        return t

    return mgr.restore(step, device="cpu", subtree="params", leaf_fn=leaf,
                       layout=layout)


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
