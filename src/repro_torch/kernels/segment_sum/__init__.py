from repro_torch.kernels.segment_sum.ops import plan, segment_sum  # noqa: F401
from repro_torch.kernels.segment_sum.ref import segment_sum_ref  # noqa: F401
