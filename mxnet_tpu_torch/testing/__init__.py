"""Test-support subpackage: fault injection for the serving tier
(``mxnet_tpu_torch.testing.faults``).  Nothing here is imported by
production code paths."""
from . import faults  # noqa: F401
