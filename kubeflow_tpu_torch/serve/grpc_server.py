"""gRPC Open Inference Protocol (v2) endpoint sharing a ModelServer's
models (port of ``kubeflow_tpu/serve/grpc_server.py``): the v2 protocol
over gRPC beside REST.

No generated service stubs: the service registers through
``grpc.method_handlers_generic_handler`` with the message classes of
``protos/oip_pb2.py`` doing the wire (de)serialization — the JAX package's
service ``inference.GRPCInferenceService``, its method paths and its wire
format. Methods: ServerLive, ServerReady, ServerMetadata, ModelReady,
ModelMetadata, ModelInfer (BYTES text tensors, sampling knobs in the OIP
``parameters`` map: max_tokens, temperature, top_k, top_p). ``ModelInfer``
runs ``ModelServer.generate_text``, the path REST completions take, so a
model id may name a repository entry or a LoRA adapter. Errors map to
NOT_FOUND (unknown model), INVALID_ARGUMENT, RESOURCE_EXHAUSTED (shed) and
DEADLINE_EXCEEDED; QoS and the trace header travel as lowercase
invocation metadata.

``grpc`` and ``google.protobuf`` are imported by this module and
``protos/`` only: the rest of the package runs without them, and
``ModelServer`` imports this module only when given a ``grpc_port``.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Optional

import grpc

from kubeflow_tpu_torch.core.headers import QOS_HEADER, TRACE_HEADER
from kubeflow_tpu_torch.core.serving import QOS_DEFAULT
from kubeflow_tpu_torch.obs.trace import get_tracer
from kubeflow_tpu_torch.serve.engine import EngineOverloaded
from kubeflow_tpu_torch.serve.protos import oip_pb2 as pb

SERVICE = "inference.GRPCInferenceService"


def _param_value(p: "pb.InferParameter"):
    which = p.WhichOneof("parameter_choice")
    return getattr(p, which) if which else None


class GRPCInferenceServer:
    """OIP gRPC server over a ModelServer (single- or multi-model)."""

    def __init__(self, model_server, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 8):
        self.model_server = model_server
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers,
                                       thread_name_prefix="grpc-oip"))
        rpcs = {
            "ServerLive": (self._server_live, pb.ServerLiveRequest,
                           pb.ServerLiveResponse),
            "ServerReady": (self._server_ready, pb.ServerReadyRequest,
                            pb.ServerReadyResponse),
            "ServerMetadata": (self._server_metadata,
                               pb.ServerMetadataRequest,
                               pb.ServerMetadataResponse),
            "ModelReady": (self._model_ready, pb.ModelReadyRequest,
                           pb.ModelReadyResponse),
            "ModelMetadata": (self._model_metadata, pb.ModelMetadataRequest,
                              pb.ModelMetadataResponse),
            "ModelInfer": (self._model_infer, pb.ModelInferRequest,
                           pb.ModelInferResponse),
        }
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)
            for name, (fn, req_cls, resp_cls) in rpcs.items()
        }
        self.server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        self._started = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        self._started.set()

    def stop(self, grace: float = 2.0) -> None:
        self.server.stop(grace).wait(grace + 1.0)

    @property
    def target(self) -> str:
        return f"127.0.0.1:{self.port}"

    # -- RPCs --------------------------------------------------------------

    def _server_live(self, request, context):
        return pb.ServerLiveResponse(live=True)

    def _server_ready(self, request, context):
        return pb.ServerReadyResponse(ready=True)

    def _server_metadata(self, request, context):
        return pb.ServerMetadataResponse(
            name=self.model_server.name, version="v2",
            extensions=["model_repository"])

    def _model_ready(self, request, context):
        try:
            self.model_server.model_config(request.name)
        except KeyError:
            return pb.ModelReadyResponse(ready=False)
        return pb.ModelReadyResponse(ready=True)

    def _model_metadata(self, request, context):
        try:
            cfg = self.model_server.model_config(request.name)
        except KeyError:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no model {request.name!r}")
        tensor = pb.ModelMetadataResponse.TensorMetadata
        return pb.ModelMetadataResponse(
            name=request.name, platform="kubeflow-tpu-torch-llm",
            versions=["1"],
            inputs=[tensor(name="text", datatype="BYTES", shape=[-1])],
            outputs=[tensor(name="text", datatype="BYTES", shape=[-1])])

    def _model_infer(self, request, context):
        body = {k: _param_value(v) for k, v in request.parameters.items()}
        # Trace join over gRPC: the propagation header arrives as lowercase
        # invocation metadata; the span set here parents the engine-side
        # spans through generate_text's contextvar lookup (one trace id
        # whichever protocol carried the request). QoS rides the metadata
        # under the HTTP header's lowercased name.
        tracer = get_tracer()
        md = {k.lower(): v for k, v in (context.invocation_metadata() or ())}
        qos = str(md.get(QOS_HEADER.lower(), QOS_DEFAULT)).strip().lower()
        with tracer.span("grpc.model_infer",
                         parent=tracer.extract(md.get(TRACE_HEADER.lower())),
                         model=request.model_name):
            return self._model_infer_traced(request, context, body, qos)

    def _model_infer_traced(self, request, context, body,
                            qos: str = QOS_DEFAULT):
        texts = []
        try:
            for inp in request.inputs:
                if inp.datatype != "BYTES":
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                  f"input {inp.name!r}: only BYTES text "
                                  f"tensors are served (got {inp.datatype})")
                for datum in inp.contents.bytes_contents:
                    out, _ = self.model_server.generate_text(
                        datum.decode("utf-8"), body, request.model_name,
                        strict=True, qos=qos)
                    texts.append(out.encode("utf-8"))
        except KeyError as exc:
            context.abort(grpc.StatusCode.NOT_FOUND, str(exc))
        except ValueError as exc:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        except EngineOverloaded as exc:
            # Bounded-admission shed: the gRPC analog of HTTP 429.
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(exc))
        except TimeoutError as exc:
            # Deadline reap or cancellation: the analog of HTTP 504.
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(exc))
        out_tensor = pb.ModelInferResponse.InferOutputTensor(
            name="text", datatype="BYTES", shape=[len(texts)])
        out_tensor.contents.bytes_contents.extend(texts)
        return pb.ModelInferResponse(
            model_name=request.model_name, id=request.id,
            outputs=[out_tensor])


def oip_connect(target: str):
    """``(channel, stub)`` over an insecure channel to ``target`` (a
    ``host:port``); the caller closes the channel. Callers that import no
    ``grpc`` of their own use it."""
    channel = grpc.insecure_channel(target)
    return channel, oip_stub(channel)


def oip_stub(channel: grpc.Channel):
    """Client-side convenience: method callables with the right serializers
    (what generated stubs would have provided)."""
    def m(name, req_cls, resp_cls):
        return channel.unary_unary(
            f"/{SERVICE}/{name}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString)

    class Stub:
        ServerLive = m("ServerLive", pb.ServerLiveRequest,
                       pb.ServerLiveResponse)
        ServerReady = m("ServerReady", pb.ServerReadyRequest,
                        pb.ServerReadyResponse)
        ServerMetadata = m("ServerMetadata", pb.ServerMetadataRequest,
                           pb.ServerMetadataResponse)
        ModelReady = m("ModelReady", pb.ModelReadyRequest,
                       pb.ModelReadyResponse)
        ModelMetadata = m("ModelMetadata", pb.ModelMetadataRequest,
                          pb.ModelMetadataResponse)
        ModelInfer = m("ModelInfer", pb.ModelInferRequest,
                       pb.ModelInferResponse)

    return Stub()
