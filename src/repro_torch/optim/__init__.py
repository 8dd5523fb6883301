from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          clip_by_global_norm,
                                          constant_schedule, cosine_schedule,
                                          make_optimizer, sgd,
                                          warmup_cosine_schedule,
                                          write_scalars)

__all__ = [
    "Optimizer", "sgd", "adam", "adamw", "make_optimizer",
    "cosine_schedule", "constant_schedule", "warmup_cosine_schedule",
    "clip_by_global_norm", "write_scalars",
]
