"""Single-device training for the port: optimizer, data, train step,
metrics, input staging, checkpoints, survivability and the trainer loop
(port of ``kubeflow_tpu/train/``)."""
