"""Runtime helpers of the port (a minimal copy of ``kubeflow_tpu/runtime``)."""
