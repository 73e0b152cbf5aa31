"""mx.contrib.onnx (parity: mxnet_tpu/contrib/onnx/; reference
python/mxnet/contrib/onnx/).

Self-contained: serialization speaks the protobuf wire format directly
(see _proto), so no onnx package is required.
"""
from .mx2onnx import export_model  # noqa: F401
from .onnx2mx import import_model, get_model_metadata  # noqa: F401
