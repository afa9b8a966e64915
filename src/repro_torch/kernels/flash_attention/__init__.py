from repro_torch.kernels.flash_attention.ops import (attention_bshd,  # noqa: F401
                                                    flash_attention, plan)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_ref, attention_split_ref)
