"""kubeflow_tpu_torch — the PyTorch/CUDA port of kubeflow_tpu's data plane.

A second package beside ``kubeflow_tpu``: the same module layout and names,
written in PyTorch for an NVIDIA Hopper card, with every Pallas kernel on a
ported path replaced by a kernel written by hand for ``sm_90a`` (CUDA C++ in
``csrc/``, or Triton for fused elementwise and normalisation passes).

The package imports ``torch``, numpy and the standard library only — never
``jax`` and never ``kubeflow_tpu``. Entry points take ``device=`` and
default to ``"cuda"``; without a card they raise unless the caller passes
``device="cpu"`` explicitly (the CPU runs each kernel's plain version).
"""

from kubeflow_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
