from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, cosine_schedule,
                                     global_norm)
from repro_torch.optim.compression import (ef_compress_psum,  # noqa: F401
                                           ef_state_init)
