"""Open Inference Protocol messages (``oip_pb2``, built from ``oip.proto``
in a private descriptor pool)."""
