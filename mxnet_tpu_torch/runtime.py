"""Runtime feature detection (parity: mxnet_tpu/runtime.py:8-69,
python/mxnet/runtime.py, src/libinfo.cc), read from the torch build:
CUDA, cuDNN, NCCL and BF16 as torch reports them; no TPU, XLA or
Pallas."""
from __future__ import annotations

import importlib.util

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return "%s %s" % ("✔" if self.enabled else "✖", self.name)


def _bf16():
    if torch.cuda.is_available():
        return torch.cuda.is_bf16_supported()
    return True     # the CPU kernels take bf16


def _detect():
    import torch.distributed as dist

    return {
        "CPU": True,
        "TPU": False,
        "CUDA": torch.version.cuda is not None,
        "CUDNN": torch.backends.cudnn.is_available(),
        "NCCL": dist.is_available() and dist.is_nccl_available(),
        "TENSORRT": False,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "XLA": False,
        "PALLAS": False,
        "BLAS_OPEN": True,
        "LAPACK": torch.backends.mkl.is_available()
        or torch.version.cuda is not None,
        "OPENCV": importlib.util.find_spec("cv2") is not None,
        "DIST_KVSTORE": dist.is_available(),
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": True,
        "PROFILER": True,
        "F16C": True,
        "BF16": _bf16(),
        "OPENMP": torch.backends.openmp.is_available(),
        "SSE": False,
        "JEMALLOC": False,
    }


class Features(dict):
    def __init__(self):
        super().__init__([(k, Feature(k, v)) for k, v in _detect().items()])

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError("Feature '%s' is unknown" % feature_name)
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())
