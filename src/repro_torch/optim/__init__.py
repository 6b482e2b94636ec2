from repro_torch.optim.optimizers import (AdamWState, adamw_init,
                                          adamw_update, AdafactorState,
                                          adafactor_init, adafactor_update,
                                          clip_by_global_norm,
                                          cosine_schedule, Optimizer,
                                          make_optimizer)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "AdafactorState",
           "adafactor_init", "adafactor_update", "clip_by_global_norm",
           "cosine_schedule", "Optimizer", "make_optimizer"]
