"""The platform's ``X-Kftpu-*`` header names (a copy of
``kubeflow_tpu/core/headers.py``: the port imports nothing of the JAX
package). The names are a wire contract shared with the JAX package's
router, loadgen and servers, so the two copies must stay identical — the
port's tests compare them."""

from __future__ import annotations

#: Trace-context propagation: ``<trace_id>-<parent_span_id>``. Stamped by
#: the router, joined by the model server (REST and gRPC — gRPC carries it
#: as lowercase invocation metadata).
TRACE_HEADER = "X-Kftpu-Trace"

#: Remaining client budget in milliseconds; stamped/decremented hop by hop
#: (client → router → replica) so every layer enforces the SAME deadline.
DEADLINE_HEADER = "X-Kftpu-Deadline-Ms"

#: Multi-tenant QoS class (core/serving.QOS_CLASSES), carried end-to-end:
#: client → router → model server → engine scheduler.
QOS_HEADER = "X-Kftpu-Qos"

#: Caller identity for the platform API server (profile-namespace access
#: checks). Client-side only — never forwarded onto the serving path.
USER_HEADER = "X-Kftpu-User"

#: Multi-tenant model routing: the model id (base model or registered
#: LoRA adapter, serve/lora.py) a request targets. Stamped by clients /
#: the loadgen (the OpenAI ``"model"`` body field is the headerless
#: fallback), read by the fleet router — which prefers a backend that
#: already has the adapter HOT (scraped off the
#: ``kftpu_engine_adapters_resident`` series) — and by the model
#: server, which resolves it to a repository model or an engine
#: adapter; unknown ids are 404s, never silent base-model fallthrough.
MODEL_HEADER = "X-Kftpu-Model"

#: Disaggregated prefill/decode serving: the URL of the decode-pool
#: backend a prefill replica must hand its KV off to. Stamped by the
#: token-aware router (which picked it on least-resident-KV-pages) onto
#: the request it places on the prefill pool; the prefill model server
#: reads it and POSTs the paged-KV handoff there. Absent header = no
#: handoff (unified-fallback path: the replica decodes locally).
DECODE_BACKEND_HEADER = "X-Kftpu-Decode-Backend"

#: Fleet-wide KV fabric: comma-separated ALTERNATE decode backends for
#: the handoff's bounded retry. The router stamps the primary decode
#: target in ``DECODE_BACKEND_HEADER`` and up to two more healthy
#: decode-pool members here; a prefill replica whose handoff POST
#: fails retries (jittered exponential backoff, serve/retry.py) against
#: a DIFFERENT replica from this list before degrading to local
#: recompute. Absent/empty = no cross-replica retry (single-decode
#: fleets, direct-to-replica traffic).
DECODE_ALTS_HEADER = "X-Kftpu-Decode-Alts"

#: Handoff capability negotiation: the KV cache dtype the payload's
#: page bytes are encoded in (``int8`` for quantized pools, ``full``
#: otherwise). Stamped on the handoff POST by the prefill side; the
#: decode side REJECTS a mismatch with an explicit 409 BEFORE decoding
#: the wire blob — a mixed-dtype fleet must fail the submit cleanly
#: (prefill recomputes locally), never corrupt pages.
HANDOFF_DTYPE_HEADER = "X-Kftpu-Kv-Dtype"

#: Handoff wire-format version (serve/handoff.py: ``1`` = raw K/V
#: planes, ``2`` = + per-token-per-head scale rows). A decode replica
#: that doesn't speak the payload's version 409s at submit — the
#: mixed-version-fleet half of the capability negotiation.
HANDOFF_WIRE_HEADER = "X-Kftpu-Kv-Wire"

#: Headers a transparent serving-path middlebox (the ChaosProxy, any
#: future sidecar) MUST forward for the request-lifecycle machinery to
#: keep working through it: deadline enforcement, QoS policy, trace
#: continuity, and disaggregated handoff placement all ride these.
#: ``kftpu lint`` X703 checks that every header exchanged on the
#: serving path appears here.
FORWARD_HEADERS = (DEADLINE_HEADER, QOS_HEADER, TRACE_HEADER,
                   DECODE_BACKEND_HEADER, DECODE_ALTS_HEADER,
                   MODEL_HEADER, HANDOFF_DTYPE_HEADER,
                   HANDOFF_WIRE_HEADER)
