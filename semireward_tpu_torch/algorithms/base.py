"""Algorithm protocol (port of ``semireward_tpu/algorithms/base.py``).

An algorithm maps a :class:`StepCtx` to a :class:`LossOut`; the train step
(``core/step.py``) backpropagates ``total_loss``, steps the optimizer and
keeps the returned algorithm state.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.core.losses import (ce_loss, consistency_loss,
                                              gen_ulb_targets)
from semireward_tpu_torch.parallel import mesh as mesh_lib


class StepCtx(NamedTuple):
    model: Any                 # callable: model(x, train=, generator=)
    batch: Dict[str, torch.Tensor]
    algo_state: Any
    generator: Optional[torch.Generator]
    step: int                  # host int, == reference `self.it`
    sr_state: Any = None       # SemiReward state (SR variants only)
    ema: Optional[List[torch.Tensor]] = None  # EMA shadow (MeanTeacher)


class LossOut(NamedTuple):
    total_loss: torch.Tensor
    sup_loss: torch.Tensor
    unsup_loss: torch.Tensor
    extra_loss: Optional[torch.Tensor]  # e.g. FreeMatch's entropy term
    unsup_weight: float                 # lambda_u * warm-up factor
    mask: Optional[torch.Tensor]
    pseudo_label: Optional[torch.Tensor]
    fwd: Optional[C.ForwardOut]
    new_algo_state: Any
    metrics: Dict[str, torch.Tensor]


class Algorithm:
    """Base. Subclasses override ``init_state`` and ``loss``."""

    NAME = "base"
    DEFAULTS: Dict[str, Any] = {}
    BATCH_KEYS: Tuple[str, ...] = ("x_lb", "y_lb", "idx_ulb", "x_ulb_w",
                                   "x_ulb_s")
    WEAK_ULB_S: bool = False
    # a supervised pre-stage before the first step (Dash's)
    NEEDS_WARMUP: bool = False
    # the loss takes its batch statistics over the global batch on a mesh
    # (parallel/mesh.py); every other algorithm refuses a mesh of more than
    # one rank
    MESH_READY: bool = False

    def __init__(self, cfg, data_info: Optional[Dict[str, Any]] = None,
                 device=None):
        self.check_ported(cfg)
        mesh = mesh_lib.active()
        if mesh is not None and mesh.world > 1 and not self.MESH_READY:
            raise NotImplementedError(
                f"{self.NAME} ({type(self).__name__}) on a mesh of "
                f"{mesh.world} ranks is not ported yet (ROADMAP item 16: "
                f"the algorithms on a mesh)")
        self.cfg = cfg
        self.data_info = data_info or {}
        self.device = device

    @classmethod
    def check_ported(cls, cfg) -> None:
        """Raise where ``cfg`` asks this algorithm for a form that the port
        does not run, before any data is loaded (the trainer asks first):
        one not ported yet (``NotImplementedError`` naming its ROADMAP
        item), or one on which the JAX package's loss fails at its first
        step (the same exception type, naming the switch or key)."""

    def ce_loss(self, logits, targets, reduction="none"):
        return ce_loss(logits, targets, reduction)

    def consistency_loss(self, logits, targets, name="ce", mask=None,
                         mask2=None):
        return consistency_loss(logits, targets, name, mask, mask2)

    def compute_prob(self, logits):
        return C.compute_prob(logits)

    def gen_ulb_targets(self, logits, use_hard_label=True, T=1.0,
                        softmax=True, label_smoothing=0.0):
        return gen_ulb_targets(logits, use_hard_label, T, softmax,
                               label_smoothing)

    def fixed_mask(self, probs):
        return C.fixed_threshold_mask(probs, self.cfg.p_cutoff)

    def maybe_dist_align(self, probs_x_ulb, probs_x_lb=None):
        return probs_x_ulb

    def wrap_model(self, model, generator=None):
        """The net the algorithm trains: ``model`` itself, or ``model``
        under a wrapper that adds heads (``models/wrappers.py``), their
        weights drawn from ``generator``."""
        return model

    def init_state(self):
        return ()

    def loss(self, ctx: StepCtx) -> LossOut:
        raise NotImplementedError

    def forward(self, ctx: StepCtx, stop_grad_w: bool = True) -> C.ForwardOut:
        # the JAX package's auto_split_forward (weak view forward-only) was
        # chosen by a TPU measurement; the port takes the exact concat path
        # until an H100 A/B decides
        if self.cfg.extra.get("auto_split_forward", False):
            raise NotImplementedError(
                "auto_split_forward is not ported yet (ROADMAP: port A/Bs)")
        b = ctx.batch
        return C.ssl_forward(ctx.model, b["x_lb"], b["x_ulb_w"], b["x_ulb_s"],
                             ctx.generator, train=True,
                             use_cat=self.cfg.use_cat, stop_grad_w=stop_grad_w)

    def unsup_warmup_factor(self, step: int, warm: Optional[float] = None
                            ) -> float:
        """clip(step / (unsup_warm_up * num_train_iter), 0, 1), in float32
        like the JAX package's (a host float: the step is a host int)."""
        warm = self.cfg.unsup_warm_up if warm is None else warm
        denom = max(warm * self.cfg.num_train_iter, 1e-9)
        return float(np.clip(np.float32(step) / np.float32(denom), 0.0, 1.0))

    def pack(self, *, sup_loss, unsup_loss, fwd, new_algo_state,
             extra_loss=None, mask=None, pseudo_label=None, lambda_u=None,
             warmup=None, metrics=None) -> LossOut:
        """``total = sup + lambda_u * unsup * warmup + extra``; a missing
        warm-up factor (1) or extra loss (0) adds no operation, which
        leaves the same bits."""
        lam = self.cfg.ulb_loss_ratio if lambda_u is None else lambda_u
        total = lam * unsup_loss
        if warmup is not None:
            total = total * warmup
        total = sup_loss + total
        if extra_loss is not None:
            total = total + extra_loss
        m = {"sup_loss": sup_loss, "unsup_loss": unsup_loss,
             "total_loss": total}
        if mask is not None:
            m["util_ratio"] = mask.float().mean()
        if metrics:
            m.update(metrics)
        w = 1.0 if warmup is None else warmup
        return LossOut(total_loss=total, sup_loss=sup_loss,
                       unsup_loss=unsup_loss, extra_loss=extra_loss,
                       unsup_weight=float(np.float32(lam) * np.float32(w)),
                       mask=mask, pseudo_label=pseudo_label, fwd=fwd,
                       new_algo_state=new_algo_state, metrics=m)


class SupervisedWarmup(Algorithm):
    """The loss of a supervised pre-stage (Dash's warm-up): CE on the
    labeled view alone; the algorithm state passes through."""

    NAME = "supervised_warmup"
    BATCH_KEYS = ("x_lb", "y_lb")

    def loss(self, ctx: StepCtx) -> LossOut:
        out = ctx.model(ctx.batch["x_lb"], train=True,
                        generator=ctx.generator)
        sup_loss = self.ce_loss(out["logits"], ctx.batch["y_lb"], "mean")
        zero = torch.zeros((), device=sup_loss.device)
        return LossOut(total_loss=sup_loss, sup_loss=sup_loss,
                       unsup_loss=zero, extra_loss=None, unsup_weight=0.0,
                       mask=None, pseudo_label=None, fwd=None,
                       new_algo_state=ctx.algo_state,
                       metrics={"sup_loss": sup_loss})
