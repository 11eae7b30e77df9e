"""Optimizers of the port: Adam, SGD, their schedules and global-norm
clipping (``optimizers.py``), and the paper's fixed-point SGD with SGA
banking (``quantized.py``).  Parameter trees are nested dicts of
tensors, flattened in sorted key order as JAX flattens its pytrees."""

from repro_torch.optim.optimizers import (OptState, Optimizer, adam,
                                          clip_by_global_norm,
                                          cosine_schedule, sgd,
                                          step_decay_schedule)
from repro_torch.optim.quantized import (QuantizedSGDState,
                                         quantized_sgd_init,
                                         quantized_sgd_step)

__all__ = [
    "OptState", "Optimizer", "adam", "sgd", "cosine_schedule",
    "step_decay_schedule", "clip_by_global_norm", "QuantizedSGDState",
    "quantized_sgd_init", "quantized_sgd_step",
]
