from repro_torch.kernels.flash_attention.ops import (attention_bshd,  # noqa: F401
                                                    flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: F401
