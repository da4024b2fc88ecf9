"""Weight initializers of the JAX package (``models/initializers.py``).

Kernels draw uniform with variance 1/(3*fan_in) (torch's Linear/Conv2d
default, kaiming_uniform(a=sqrt(5))); biases start at zero, as the JAX
package documents. Draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from semireward_tpu_torch import rng


@torch.no_grad()
def torch_default_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    fan_in = weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    return rng.init_(weight, torch.Tensor.uniform_, -bound, bound,
                     generator=generator)


@torch.no_grad()
def init_module_(module: nn.Module, generator=None) -> nn.Module:
    """Torch-default kernels and zero biases for every Linear/Conv2d inside
    ``module``; LayerNorm scale 1, bias 0; Embedding N(0, 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            torch_default_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            rng.init_(m.weight, torch.Tensor.normal_, 0.0, 1.0,
                      generator=generator)
    return module
