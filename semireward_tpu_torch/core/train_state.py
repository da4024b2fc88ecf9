"""Training state (port of ``semireward_tpu/core/train_state.py``).

The JAX package threads one immutable pytree through a donated jitted step.
Here the state is a plain object whose tensors the step updates in place:
the model's parameters, the EMA shadow, the optimizer moments. The step
count is a host int, so every schedule and stage condition is a Python
branch that never waits for the device. BatchNorm running statistics (the
JAX package's ``batch_stats``) are model buffers that the forwards update
in place; the EMA shadows parameters only, and eval runs the EMA
parameters with the live running statistics, as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch
from torch import nn


@dataclass
class SRState:
    """SemiReward online-training state. The generator never moves: in the
    reference its output passes through ``.long()`` before reaching the
    rewarder, so no gradient reaches it."""

    rewarder: nn.Module
    rewarder_opt: Any                 # core.optim.Optimizer (Adam)
    rewarder_ema: Optional[List[torch.Tensor]]  # EMA shadow, None if sr_ema off
    generator: nn.Module
    max_reward: torch.Tensor          # f32 scalar on the device, init -inf


@dataclass
class TrainState:
    step: int
    model: nn.Module
    ema: List[torch.Tensor]           # EMA shadow of model.parameters()
    opt: Any                          # core.optim.Optimizer
    algo: Any                         # per-algorithm statistics
    sr: Optional[SRState]


@torch.no_grad()
def tree_ema(shadow: Sequence[torch.Tensor], new: Sequence[torch.Tensor],
             decay: float) -> None:
    """shadow <- decay*shadow + (1-decay)*new, in place."""
    if decay == 0.0:
        torch._foreach_copy_(list(shadow), list(new))
        return
    torch._foreach_mul_(list(shadow), decay)
    torch._foreach_add_(list(shadow), list(new), alpha=1.0 - decay)
