from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, global_norm)
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        linear_warmup_cosine)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "constant_schedule", "cosine_schedule",
           "linear_warmup_cosine"]
