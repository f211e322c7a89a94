from repro_torch.optim.adamw import (AdamWState, apply_updates,
                                     clip_by_global_norm, init_state,
                                     lr_schedule)

__all__ = ["AdamWState", "apply_updates", "clip_by_global_norm",
           "init_state", "lr_schedule"]
