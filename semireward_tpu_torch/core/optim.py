"""Optimizers and LR schedule (port of ``semireward_tpu/core/optim.py``).

The update is written by hand to reproduce the optax chain of the JAX
package step for step: global-norm clip -> Adam moments (or SGD trace) ->
masked decoupled weight decay -> per-parameter layer-decay scale -> LR. The
LR of update k (k = 0, 1, ...) is the schedule at count k, read before the
count increments (optax ``scale_by_learning_rate``). The step count is a host
int, so the LR is a host float and no step waits for the device.
Parameters update in place with multi-tensor (``torch._foreach_*``) ops.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from semireward_tpu_torch.core.train_state import check_leaves


def cosine_schedule_with_warmup(lr: float, num_training_steps: int,
                                num_warmup_steps: int = 0,
                                num_cycles: float = 7.0 / 16.0) -> Callable:
    """LR at a step count, in float32 arithmetic like the JAX schedule."""
    f32 = np.float32

    def sched(count: int) -> float:
        c = f32(count)
        if count < num_warmup_steps:
            mult = c / f32(max(1.0, float(num_warmup_steps)))
        else:
            denom = f32(max(1, num_training_steps - num_warmup_steps))
            frac = (c - f32(num_warmup_steps)) / denom
            mult = max(f32(0.0), np.cos(f32(math.pi * num_cycles) * frac,
                                        dtype=f32))
        return float(f32(lr) * f32(mult))

    return sched


def default_wd_mask(model: nn.Module) -> Dict[str, bool]:
    """True = apply weight decay. Skips biases, norm and embedding weights,
    cls/pos tokens: the JAX package's flax-name rules (optim.py:56-72) on
    the port's parameter names and module types."""
    out = {}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            parts = [n.lower() for n in full.split(".")]
            skip = (
                p_name == "bias"
                or isinstance(mod, (nn.LayerNorm, nn.Embedding,
                                    nn.modules.batchnorm._BatchNorm))
                or parts[-1] in ("embedding", "cls_token", "pos_embed", "cls",
                                 "mask_token")
                or any("norm" in n or n.startswith("bn") or n.endswith("_bn")
                       for n in parts[:-1])
            )
            out[full] = (not skip) and p.ndim > 1
    return out


def layer_decay_scales(names: Sequence[str], layer_decay: float,
                       layer_id_fn: Callable[[List[str], int], int],
                       num_layers: int) -> Dict[str, float]:
    """scale = layer_decay ** (num_layers - layer_id): 1.0 for the head,
    the deepest decay for the embeddings."""
    return {n: layer_decay ** (num_layers - layer_id_fn(n.split("."),
                                                        num_layers))
            for n in names}


class Optimizer:
    """AdamW / Adam / SGD(nesterov) over a list of parameters, updated in
    place. ``wd_mask`` and ``scales`` are per-parameter (None = all True /
    all 1.0)."""

    def __init__(self, params: Sequence[torch.Tensor], kind: str,
                 schedule: Callable[[int], float], momentum: float = 0.9,
                 weight_decay: float = 0.0, nesterov: bool = True,
                 clip_grad: float = 0.0, wd_mask: Optional[Sequence[bool]] = None,
                 scales: Optional[Sequence[float]] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 names: Optional[Sequence[str]] = None):
        kind = kind.lower()
        if kind not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown optimizer {kind}")
        self.params = list(params)
        # the parameters' names, which key the moments in state_dict()
        self.names = (list(names) if names is not None
                      else [str(i) for i in range(len(self.params))])
        self.kind, self.schedule = kind, schedule
        self.momentum, self.nesterov = momentum, nesterov
        self.weight_decay = weight_decay if kind != "adam" else 0.0
        self.clip_grad = clip_grad
        self.b1, self.b2, self.eps = b1, b2, eps
        n = len(self.params)
        wd_mask = list(wd_mask) if wd_mask is not None else [True] * n
        scales = list(scales) if scales is not None else [1.0] * n
        self._wd_idx = [i for i in range(n) if wd_mask[i]]
        groups: Dict[float, List[int]] = {}
        for i, s in enumerate(scales):
            groups.setdefault(float(s), []).append(i)
        self._scale_groups = sorted(groups.items())
        self.count = 0
        # the clip's squared global norm of the gradients where they are
        # blocks of a mesh layout (parallel/mesh.py:Layout.sq_norm)
        self.sq_norm_fn: Optional[Callable] = None
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        if kind == "sgd":
            self.trace = zeros()
        else:
            self.mu, self.nu = zeros(), zeros()

    def _moments(self) -> Dict[str, List[torch.Tensor]]:
        return ({"trace": self.trace} if self.kind == "sgd"
                else {"mu": self.mu, "nu": self.nu})

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """``count`` and the moments (``mu.<name>`` / ``nu.<name>``, or
        ``trace.<name>`` for SGD), the live tensors."""
        out = {"count": torch.tensor(self.count, dtype=torch.int64)}
        for kind, ts in self._moments().items():
            out.update(zip((f"{kind}.{n}" for n in self.names), ts))
        return out

    @torch.no_grad()
    def load_state_dict(self, src: Dict[str, torch.Tensor]) -> None:
        """Copy a :meth:`state_dict` into the moments in place (names,
        shapes and dtypes checked first) and set the count."""
        live = self.state_dict()
        check_leaves(src, live, "optimizer")
        for name, dst in live.items():
            if name != "count":
                dst.copy_(src[name])
        self.count = int(src["count"])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        g = [x.float() for x in grads]
        if self.clip_grad and self.clip_grad > 0:
            norm = (torch.sqrt(self.sq_norm_fn(g)) if self.sq_norm_fn
                    else torch.linalg.vector_norm(
                        torch.stack(torch._foreach_norm(g))))
            factor = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                 self.clip_grad / norm)
            g = torch._foreach_mul(g, factor)
        lr = self.schedule(self.count)
        self.count += 1
        p = self.params
        if self.kind == "sgd":
            if self.weight_decay:
                idx = self._wd_idx
                g = list(g)
                upd_wd = torch._foreach_add([g[i] for i in idx],
                                            [p[i] for i in idx],
                                            alpha=self.weight_decay)
                for i, t in zip(idx, upd_wd):
                    g[i] = t
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, g)
            upd = (torch._foreach_add(g, self.trace, alpha=self.momentum)
                   if self.nesterov else [t.clone() for t in self.trace])
        else:
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(self.nu, self.b2)
            torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
            bc1 = float(1.0 - np.float32(self.b1) ** np.float32(self.count))
            bc2 = float(1.0 - np.float32(self.b2) ** np.float32(self.count))
            den = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(self.mu, bc1)
            torch._foreach_div_(upd, den)
            if self.weight_decay:
                idx = self._wd_idx
                torch._foreach_add_([upd[i] for i in idx], [p[i] for i in idx],
                                    alpha=self.weight_decay)
        for scale, idx in self._scale_groups:
            u = [upd[i] for i in idx]
            if scale != 1.0:
                torch._foreach_mul_(u, scale)
            torch._foreach_add_([p[i] for i in idx], u, alpha=-lr)


def build_optimizer(model: nn.Module, optim_name: str = "SGD",
                    lr: float = 0.03, momentum: float = 0.9,
                    weight_decay: float = 0.0, layer_decay: float = 1.0,
                    nesterov: bool = True, num_training_steps: int = 1,
                    num_warmup_steps: int = 0, clip_grad: float = 0.0,
                    layer_id_fn: Optional[Callable] = None,
                    num_layers: int = 0) -> Optimizer:
    """The JAX ``build_optimizer`` (per-leaf chain) over ``model``'s
    parameters, in ``named_parameters`` order."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    mask = default_wd_mask(model)
    scales = None
    if layer_decay != 1.0 and layer_id_fn is not None:
        sc = layer_decay_scales(names, layer_decay, layer_id_fn, num_layers)
        scales = [sc[n] for n in names]
    return Optimizer(params, optim_name,
                     cosine_schedule_with_warmup(lr, num_training_steps,
                                                 num_warmup_steps),
                     momentum=momentum, weight_decay=weight_decay,
                     nesterov=nesterov, clip_grad=clip_grad,
                     wd_mask=[mask[n] for n in names], scales=scales,
                     names=names)


def build_adam(module: nn.Module, lr: float) -> Optimizer:
    """Plain Adam at a constant LR over ``module``'s parameters (the
    SemiReward rewarder)."""
    names, params = zip(*module.named_parameters())
    return Optimizer(params, "adam", lambda count: lr, names=names)
