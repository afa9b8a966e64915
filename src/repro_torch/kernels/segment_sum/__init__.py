from repro_torch.kernels.segment_sum.ops import (  # noqa: F401
    grad_vector_width, plan, segment_sum, segment_sum_backward)
from repro_torch.kernels.segment_sum.ref import (  # noqa: F401
    segment_sum_grad_ref, segment_sum_ref)
