"""Open Inference Protocol messages (``oip.proto``, package ``inference``)
built in a private descriptor pool.

The JAX package's generated ``oip_pb2`` registers ``inference.*`` in
protobuf's default pool, and a second registration of the same symbols there
fails (``duplicate symbol``), so the port's copy builds the same file
descriptor into a pool of its own and makes its message classes from it.
Message full names never travel on the wire, so both packages' messages
speak the same bytes under the same gRPC method paths. ``_SERIALIZED`` is the
compiled ``oip.proto`` (a ``FileDescriptorProto``).
"""

from google.protobuf import descriptor_pool, message_factory

_SERIALIZED = (
    b'\n)kubeflow_tpu_torch/serve/protos/oip.proto\x12\tinference"\x13\n'
    b'\x11ServerLiveRequest""\n\x12ServerLiveResponse\x12\x0c\n\x04live'
    b'\x18\x01 \x01(\x08"\x14\n\x12ServerReadyRequest"$\n\x13ServerReadyRe'
    b'sponse\x12\r\n\x05ready\x18\x01 \x01(\x08"2\n\x11ModelReadyRequest'
    b'\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01'
    b'(\t"#\n\x12ModelReadyResponse\x12\r\n\x05ready\x18\x01 \x01(\x08"'
    b'\x17\n\x15ServerMetadataRequest"K\n\x16ServerMetadataResponse\x12'
    b'\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t'
    b'\x12\x12\n\nextensions\x18\x03 \x03(\t"5\n\x14ModelMetadataRequest'
    b'\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01'
    b'(\t"\x8d\x02\n\x15ModelMetadataResponse\x12\x0c\n\x04name\x18\x01 '
    b'\x01(\t\x12\x10\n\x08versions\x18\x02 \x03(\t\x12\x10\n\x08platform'
    b'\x18\x03 \x01(\t\x12?\n\x06inputs\x18\x04 \x03(\x0b2/.inference.Mode'
    b'lMetadataResponse.TensorMetadata\x12@\n\x07outputs\x18\x05 \x03(\x0b'
    b'2/.inference.ModelMetadataResponse.TensorMetadata\x1a?\n\x0eTensorMe'
    b'tadata\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08datatype\x18'
    b'\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\x03"\x81\x01\n\x0eInferP'
    b'arameter\x12\x14\n\nbool_param\x18\x01 \x01(\x08H\x00\x12\x15\n\x0bi'
    b'nt64_param\x18\x02 \x01(\x03H\x00\x12\x16\n\x0cstring_param\x18\x03 '
    b'\x01(\tH\x00\x12\x16\n\x0cdouble_param\x18\x04 \x01(\x01H\x00B\x12\n'
    b'\x10parameter_choice"\xd0\x01\n\x13InferTensorContents\x12\x15\n\rbo'
    b'ol_contents\x18\x01 \x03(\x08\x12\x14\n\x0cint_contents\x18\x02 \x03'
    b'(\x05\x12\x16\n\x0eint64_contents\x18\x03 \x03(\x03\x12\x15\n\ruint_'
    b'contents\x18\x04 \x03(\r\x12\x17\n\x0fuint64_contents\x18\x05 \x03('
    b'\x04\x12\x15\n\rfp32_contents\x18\x06 \x03(\x02\x12\x15\n\rfp64_cont'
    b'ents\x18\x07 \x03(\x01\x12\x16\n\x0ebytes_contents\x18\x08 \x03(\x0c'
    b'"\xd2\x06\n\x11ModelInferRequest\x12\x12\n\nmodel_name\x18\x01 \x01('
    b'\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t\x12\n\n\x02id\x18\x03 '
    b'\x01(\t\x12@\n\nparameters\x18\x04 \x03(\x0b2,.inference.ModelInferR'
    b'equest.ParametersEntry\x12=\n\x06inputs\x18\x05 \x03(\x0b2-.inferenc'
    b'e.ModelInferRequest.InferInputTensor\x12H\n\x07outputs\x18\x06 \x03('
    b'\x0b27.inference.ModelInferRequest.InferRequestedOutputTensor\x1a'
    b'\x94\x02\n\x10InferInputTensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12'
    b'\x10\n\x08datatype\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03('
    b'\x03\x12Q\n\nparameters\x18\x04 \x03(\x0b2=.inference.ModelInferRequ'
    b'est.InferInputTensor.ParametersEntry\x120\n\x08contents\x18\x05 \x01'
    b'(\x0b2\x1e.inference.InferTensorContents\x1aL\n\x0fParametersEntry'
    b'\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b2'
    b'\x19.inference.InferParameter:\x028\x01\x1a\xd5\x01\n\x1aInferReques'
    b'tedOutputTensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12[\n\nparameters'
    b'\x18\x02 \x03(\x0b2G.inference.ModelInferRequest.InferRequestedOutpu'
    b'tTensor.ParametersEntry\x1aL\n\x0fParametersEntry\x12\x0b\n\x03key'
    b'\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b2\x19.inference.In'
    b'ferParameter:\x028\x01\x1aL\n\x0fParametersEntry\x12\x0b\n\x03key'
    b'\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b2\x19.inference.In'
    b'ferParameter:\x028\x01"\xb8\x04\n\x12ModelInferResponse\x12\x12\n\nm'
    b'odel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t'
    b'\x12\n\n\x02id\x18\x03 \x01(\t\x12A\n\nparameters\x18\x04 \x03(\x0b2'
    b'-.inference.ModelInferResponse.ParametersEntry\x12@\n\x07outputs\x18'
    b'\x05 \x03(\x0b2/.inference.ModelInferResponse.InferOutputTensor\x1a'
    b'\x97\x02\n\x11InferOutputTensor\x12\x0c\n\x04name\x18\x01 \x01(\t'
    b'\x12\x10\n\x08datatype\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03'
    b'(\x03\x12S\n\nparameters\x18\x04 \x03(\x0b2?.inference.ModelInferRes'
    b'ponse.InferOutputTensor.ParametersEntry\x120\n\x08contents\x18\x05 '
    b'\x01(\x0b2\x1e.inference.InferTensorContents\x1aL\n\x0fParametersEnt'
    b'ry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01('
    b'\x0b2\x19.inference.InferParameter:\x028\x01\x1aL\n\x0fParametersEnt'
    b'ry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01('
    b'\x0b2\x19.inference.InferParameter:\x028\x01b\x06proto3'
)

POOL = descriptor_pool.DescriptorPool()
DESCRIPTOR = POOL.AddSerializedFile(_SERIALIZED)

if hasattr(message_factory, "GetMessageClass"):
    _message_class = message_factory.GetMessageClass
else:                                   # protobuf before 4.22
    _message_class = message_factory.MessageFactory(POOL).GetPrototype

ServerLiveRequest = _message_class(
    DESCRIPTOR.message_types_by_name["ServerLiveRequest"])
ServerLiveResponse = _message_class(
    DESCRIPTOR.message_types_by_name["ServerLiveResponse"])
ServerReadyRequest = _message_class(
    DESCRIPTOR.message_types_by_name["ServerReadyRequest"])
ServerReadyResponse = _message_class(
    DESCRIPTOR.message_types_by_name["ServerReadyResponse"])
ModelReadyRequest = _message_class(
    DESCRIPTOR.message_types_by_name["ModelReadyRequest"])
ModelReadyResponse = _message_class(
    DESCRIPTOR.message_types_by_name["ModelReadyResponse"])
ServerMetadataRequest = _message_class(
    DESCRIPTOR.message_types_by_name["ServerMetadataRequest"])
ServerMetadataResponse = _message_class(
    DESCRIPTOR.message_types_by_name["ServerMetadataResponse"])
ModelMetadataRequest = _message_class(
    DESCRIPTOR.message_types_by_name["ModelMetadataRequest"])
ModelMetadataResponse = _message_class(
    DESCRIPTOR.message_types_by_name["ModelMetadataResponse"])
InferParameter = _message_class(
    DESCRIPTOR.message_types_by_name["InferParameter"])
InferTensorContents = _message_class(
    DESCRIPTOR.message_types_by_name["InferTensorContents"])
ModelInferRequest = _message_class(
    DESCRIPTOR.message_types_by_name["ModelInferRequest"])
ModelInferResponse = _message_class(
    DESCRIPTOR.message_types_by_name["ModelInferResponse"])
