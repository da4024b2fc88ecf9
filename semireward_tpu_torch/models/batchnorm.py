"""BatchNorm with flax's semantics (``flax.linen.BatchNorm`` as the JAX
package's nets use it), which ``torch.nn.BatchNorm2d`` does not have:

- the running variance moves toward the BIASED batch variance, the one that
  also normalizes (torch moves it toward the unbiased one);
- ``momentum`` is flax's: ``running <- m * running + (1 - m) * batch``, so
  flax's 0.999 is torch's 0.001;
- statistics in float32, the output in the input's (compute) dtype.

In training the layer normalizes by the batch's own moments and updates
its running statistics; :func:`frozen_bn` keeps the normalization and
drops the update (the JAX package's forward whose new ``batch_stats`` are
discarded). In eval it normalizes by the running statistics. Channels are
dimension 1 (NCHW).

Under an active mesh (``parallel/mesh.py``) the batch is the global one, as
JAX's pjit makes it: each channel's sum, sum of squares and count are
summed over the batch ranks (with their gradient), and the moments are
``mean = sum / n`` and the biased ``var = sumsq / n - mean**2`` (flax's
fast variance).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from semireward_tpu_torch.parallel import mesh as mesh_lib


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.999,
                 eps: float = 1e-5):
        super().__init__()
        self.num_features, self.momentum, self.eps = num_features, momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.frozen = False

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, train: bool = True):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mesh = mesh_lib.active()
        if mesh is not None and mesh.group(mesh.batch_axes) is not None:
            return self._global(x, mesh)
        if self.frozen:
            # no running tensors: normalize by the batch's moments only
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        # the normalizing kernel's own float32 statistics: with momentum 1
        # it writes the batch mean and the UNBIASED variance into fresh
        # buffers, from which the flax update takes the biased one
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=(1.0 - m) * (n - 1) / n)
        return out

    def _global(self, x, mesh):
        """Training under a mesh: the global batch's moments."""
        C = x.shape[1]
        dims = [0] + list(range(2, x.ndim))
        xf = x.float()
        count = xf.new_full((1,), float(x.numel() // C))
        stats = mesh_lib.global_sum(
            torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]), mesh)
        n = stats[-1]
        mean = stats[:C] / n
        var = (stats[C:2 * C] / n - mean * mean).clamp_min(0.0)
        shape = (1, C) + (1,) * (x.ndim - 2)
        out = ((xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
               * self.weight.view(shape) + self.bias.view(shape))
        if not self.frozen:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return out.to(x.dtype)

    def extra_repr(self) -> str:
        return (f"{self.num_features}, momentum={self.momentum} (flax), "
                f"eps={self.eps}")


@contextlib.contextmanager
def frozen_bn(model: nn.Module):
    """Inside the block, every :class:`BatchNorm` of ``model`` in training
    normalizes by the batch's moments and leaves its running statistics
    untouched. Models without one are unaffected."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    before = [m.frozen for m in bns]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m, f in zip(bns, before):
            m.frozen = f
