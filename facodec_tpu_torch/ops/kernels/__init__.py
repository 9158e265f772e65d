# Registers the kernels' custom ops (facodec::*) with torch.library.
from facodec_tpu_torch.ops.kernels import ops  # noqa: F401
