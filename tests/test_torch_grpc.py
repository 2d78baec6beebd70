"""The port's gRPC open inference protocol endpoint on the CPU: the five
cases of tests/test_serve_grpc.py against the port's ModelServer (same
wire, same service and method paths), plus calls across the packages in
one process — the JAX ``oip_stub`` calling the port's server and the
port's stub calling the JAX server — which also proves the two ``oip_pb2``
modules coexist (the port's builds in a private descriptor pool). Greedy
text is exact: the same weights (converted from the JAX package's), fp32."""

import json
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
grpc = pytest.importorskip("grpc")

from kubeflow_tpu.core.serving import BatchingSpec as JBatchingSpec  # noqa: E402
from kubeflow_tpu.models import config as jconfig  # noqa: E402
from kubeflow_tpu.models.decoder import init_decoder_params  # noqa: E402
from kubeflow_tpu.serve import engine as jengine  # noqa: E402
from kubeflow_tpu.serve import server as jserver  # noqa: E402
from kubeflow_tpu.serve.grpc_server import oip_stub as joip_stub  # noqa: E402
from kubeflow_tpu.serve.protos import oip_pb2 as jpb  # noqa: E402
from kubeflow_tpu_torch.core.headers import QOS_HEADER  # noqa: E402
from kubeflow_tpu_torch.core.serving import BatchingSpec  # noqa: E402
from kubeflow_tpu_torch.models.config import preset  # noqa: E402
from kubeflow_tpu_torch.models.convert import params_from_jax  # noqa: E402
from kubeflow_tpu_torch.serve.engine import LLMEngine  # noqa: E402
from kubeflow_tpu_torch.serve.grpc_server import (  # noqa: E402
    SERVICE, oip_connect, oip_stub,
)
from kubeflow_tpu_torch.serve.protos import oip_pb2 as pb  # noqa: E402
from kubeflow_tpu_torch.serve.server import ModelServer  # noqa: E402
from port_threads import torch_on_one_thread  # noqa: E402,F401

SPEC = dict(max_batch_size=2, max_seq_len=96, prefill_buckets=[16, 32])


@pytest.fixture(scope="module")
def jparams():
    cfg = jconfig.preset("tiny", vocab_size=512, dtype="float32")
    return init_decoder_params(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def server(jparams):
    engine = LLMEngine(preset("tiny", vocab_size=512, dtype="float32"),
                       BatchingSpec(**SPEC),
                       params=params_from_jax(jax.tree.map(np.asarray,
                                                           jparams),
                                              device="cpu"),
                       device="cpu")
    srv = ModelServer("llm", engine, grpc_port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_server(jparams):
    engine = jengine.LLMEngine(
        jconfig.preset("tiny", vocab_size=512, dtype="float32"),
        JBatchingSpec(**SPEC), params=jparams)
    srv = jserver.ModelServer("llm", engine, grpc_port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def stub(server):
    channel, stub = oip_connect(server.grpc_server.target)
    yield stub
    channel.close()


def _infer_request(module, model="llm", text=b"hello tpu", max_tokens=6):
    req = module.ModelInferRequest(model_name=model)
    req.parameters["max_tokens"].int64_param = max_tokens
    req.parameters["temperature"].double_param = 0.0
    tin = req.inputs.add(name="text", datatype="BYTES", shape=[1])
    tin.contents.bytes_contents.append(text)
    return req


def test_health_rpcs(stub):
    assert stub.ServerLive(pb.ServerLiveRequest()).live
    assert stub.ServerReady(pb.ServerReadyRequest()).ready
    assert stub.ModelReady(pb.ModelReadyRequest(name="llm")).ready
    assert not stub.ModelReady(pb.ModelReadyRequest(name="nope")).ready


def test_server_and_model_metadata(stub):
    meta = stub.ServerMetadata(pb.ServerMetadataRequest())
    assert meta.name == "llm"
    assert list(meta.extensions) == ["model_repository"]
    mm = stub.ModelMetadata(pb.ModelMetadataRequest(name="llm"))
    assert mm.platform == "kubeflow-tpu-torch-llm"
    assert mm.inputs[0].datatype == "BYTES"
    with pytest.raises(grpc.RpcError) as exc:
        stub.ModelMetadata(pb.ModelMetadataRequest(name="nope"))
    assert exc.value.code() == grpc.StatusCode.NOT_FOUND


def test_infer_matches_rest(server, stub):
    """gRPC and REST v2 share one engine: greedy answers are identical."""
    out = stub.ModelInfer(_infer_request(pb),
                          metadata=((QOS_HEADER.lower(), "interactive"),))
    assert out.model_name == "llm"
    grpc_text = out.outputs[0].contents.bytes_contents[0].decode()
    body = json.dumps({"inputs": [{"name": "text", "datatype": "BYTES",
                                   "shape": [1], "data": ["hello tpu"]}],
                       "max_tokens": 6, "temperature": 0.0}).encode()
    http_req = urllib.request.Request(
        server.url + "/v2/models/llm/infer", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(http_req, timeout=120) as r:
        rest_text = json.loads(r.read())["outputs"][0]["data"][0]
    assert grpc_text == rest_text
    assert len(grpc_text) > 0
    # An unknown QoS class in the metadata is INVALID_ARGUMENT (HTTP 400).
    with pytest.raises(grpc.RpcError) as exc:
        stub.ModelInfer(_infer_request(pb),
                        metadata=((QOS_HEADER.lower(), "platinum"),))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_infer_bad_datatype_rejected(stub):
    req = pb.ModelInferRequest(model_name="llm")
    tin = req.inputs.add(name="ids", datatype="INT32", shape=[2])
    tin.contents.int_contents.extend([1, 2])
    with pytest.raises(grpc.RpcError) as exc:
        stub.ModelInfer(req)
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_infer_unknown_model(stub):
    req = _infer_request(pb, model="ghost", text=b"x")
    with pytest.raises(grpc.RpcError) as exc:
        stub.ModelInfer(req)
    assert exc.value.code() == grpc.StatusCode.NOT_FOUND


def test_service_and_descriptors_match_the_jax_package():
    """The same service name, message names, fields and numbering; the
    port's messages live in their own pool, the JAX ones in the default."""
    from kubeflow_tpu.serve import grpc_server as jgrpc

    assert SERVICE == jgrpc.SERVICE == "inference.GRPCInferenceService"
    jfile, tfile = jpb.DESCRIPTOR, pb.DESCRIPTOR
    assert tfile.package == jfile.package == "inference"
    assert sorted(tfile.message_types_by_name) == \
        sorted(jfile.message_types_by_name)

    def fields(desc):
        out = {f.name: (f.number, f.type, f.message_type and
                         f.message_type.name) for f in desc.fields}
        for nested in desc.nested_types:
            out[nested.name] = fields(nested)
        return out

    for name in jfile.message_types_by_name:
        assert fields(tfile.message_types_by_name[name]) == \
            fields(jfile.message_types_by_name[name]), name
    assert pb.POOL is not None and tfile.pool is pb.POOL


def test_jax_stub_calls_the_port_server(server, stub):
    channel = grpc.insecure_channel(server.grpc_server.target)
    try:
        jstub = joip_stub(channel)
        assert jstub.ServerLive(jpb.ServerLiveRequest()).live
        assert not jstub.ModelReady(jpb.ModelReadyRequest(name="nope")).ready
        got = jstub.ModelInfer(_infer_request(jpb))
        assert isinstance(got, jpb.ModelInferResponse)
        want = stub.ModelInfer(_infer_request(pb))
        assert got.outputs[0].contents.bytes_contents[0] == \
            want.outputs[0].contents.bytes_contents[0]
        with pytest.raises(grpc.RpcError) as exc:
            jstub.ModelInfer(_infer_request(jpb, model="ghost"))
        assert exc.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        channel.close()


def test_port_stub_calls_the_jax_server(jax_server, stub):
    """The port's stub against the JAX server on the same weights: the same
    greedy text as the port's own server gives."""
    channel = grpc.insecure_channel(jax_server.grpc_server.target)
    try:
        tstub = oip_stub(channel)
        assert tstub.ServerReady(pb.ServerReadyRequest()).ready
        assert tstub.ModelReady(pb.ModelReadyRequest(name="llm")).ready
        meta = tstub.ModelMetadata(pb.ModelMetadataRequest(name="llm"))
        assert meta.platform == "kubeflow-tpu-llm"
        got = tstub.ModelInfer(_infer_request(pb))
        assert isinstance(got, pb.ModelInferResponse)
        want = stub.ModelInfer(_infer_request(pb))
        assert got.outputs[0].contents.bytes_contents[0] == \
            want.outputs[0].contents.bytes_contents[0]
    finally:
        channel.close()
