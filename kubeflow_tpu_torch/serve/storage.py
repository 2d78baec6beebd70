"""Model storage: resolve a ``storageUri`` to decoder params before serving
(port of ``kubeflow_tpu/serve/storage.py``; the storage-initializer
analog).

Schemes:

- ``file:///dir`` — a checkpoint directory in the port's own format
  (``train/checkpoint.py``: one ``.pt`` per tensor, a manifest per step),
  as a port ``Trainer`` writes it. The JAX package reads orbax
  checkpoints here; the port reads no orbax (a JAX-trained tree comes
  across through ``models.convert.params_from_jax`` and a port save).
- ``random://`` (or no URI) — fresh random weights from ``seed``, for
  load tests and smoke runs.
- ``artifact://`` — the platform's artifact store, which the port does
  not have yet (ROADMAP.md Queue 1 item 9).

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

#: What ``file://`` expects to find, named in its errors.
FILE_FORMAT = ("a kubeflow_tpu_torch checkpoint directory (train/"
               "checkpoint.py: <dir>/<step>/meta.json and one .pt per tensor)")


def load_params(storage_uri: Optional[str], cfg: DecoderConfig, *,
                seed: int = 0,
                device: str | torch.device = "cuda") -> Params:
    """Resolve ``storage_uri`` into a decoder param tree on ``device``.

    file:///path — the latest step's ``params`` subtree of a port
    checkpoint directory, verified against its manifest, cast to
    ``cfg.param_dtype``.
    random:// or None — ``init_decoder_params`` from a generator on
    ``device`` seeded with ``seed``: the same weights as an engine built
    with that seed and ``weights_dtype`` equal to ``cfg.param_dtype``.
    artifact:// — not in the port yet (``ValueError``)."""
    dev = resolve_device(device)
    if storage_uri is None or storage_uri.startswith("random://"):
        return init_decoder_params(torch.Generator(dev).manual_seed(seed),
                                   cfg)
    parsed = urlparse(storage_uri)
    if parsed.scheme == "file":
        return _load_checkpoint(parsed.path, cfg, dev)
    if parsed.scheme == "artifact":
        raise ValueError(
            f"storageUri {storage_uri!r}: the artifact store is not in the "
            "port yet (ROADMAP.md Queue 1 item 9); use file:// or random://")
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
    params = CheckpointManager(path).restore(device=device,
                                             subtree="params")
    if params is None:
        raise FileNotFoundError(
            f"no checkpoint steps under {path}; expected {FILE_FORMAT}")
    dt = cfg.weight_dtype
    return T.map_tree(lambda t: t.to(dt) if t.is_floating_point() else t,
                      params)
