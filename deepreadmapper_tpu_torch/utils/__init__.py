"""Host utilities, copied from deepreadmapper_tpu/utils."""

from deepreadmapper_tpu_torch.utils.logging import log, set_verbose  # noqa: F401
from deepreadmapper_tpu_torch.utils.trace import Tracer, stage  # noqa: F401
