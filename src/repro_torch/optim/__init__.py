from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                     clip_by_global_norm, cosine_lr,
                                     global_norm, init, update)

__all__ = ["AdamWConfig", "AdamWState", "clip_by_global_norm", "cosine_lr",
           "global_norm", "init", "update"]
