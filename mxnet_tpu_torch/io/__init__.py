"""mx.io namespace (parity: mxnet_tpu/io/, python/mxnet/io/)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, CSVIter,  # noqa: F401
                 MNISTIter, ImageRecordIter, ResizeIter, PrefetchingIter,
                 LibSVMIter)
from .prefetch import DevicePrefetcher  # noqa: F401
