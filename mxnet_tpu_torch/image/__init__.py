"""mx.image namespace (parity: mxnet_tpu/image/, python/mxnet/image/)."""
from .image import *  # noqa: F401,F403
from .detection import (  # noqa: F401
    DetAugmenter, DetBorrowAug, DetRandomSelectAug, DetHorizontalFlipAug,
    DetRandomCropAug, DetRandomPadAug, CreateMultiRandCropAugmenter,
    CreateDetAugmenter, ImageDetIter)
from . import detection as det  # noqa: F401
