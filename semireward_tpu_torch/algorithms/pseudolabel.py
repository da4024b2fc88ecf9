"""Pseudo-Label and FullySupervised (port of
``semireward_tpu/algorithms/pseudolabel.py``).

PseudoLabel runs two forwards: the labeled view, and the unlabeled weak
view with BatchNorm frozen (normalized by its own batch moments, running
statistics left as they were: ``models/batchnorm.py:frozen_bn``). The
unsupervised CE back-propagates through the same unlabeled logits that
gave the (detached) hard pseudo labels, ramped by ``unsup_warm_up``. The
regression branch (Gaussian input noise, an L1 consistency) is not ported
yet, as the port's other regression paths are not.
"""
from __future__ import annotations

import torch

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.registry import ALGORITHMS


def _refuse_regression(cfg, name: str):
    if cfg.is_regression:
        raise NotImplementedError(
            f"{name} on a regression task is not ported yet (ROADMAP: the "
            f"regression datasets)")


@ALGORITHMS.register("fullysupervised")
@ALGORITHMS.register("supervised")
class FullySupervised(Algorithm):
    NAME = "fullysupervised"
    BATCH_KEYS = ("x_lb", "y_lb")

    def __init__(self, cfg, data_info=None, device=None):
        super().__init__(cfg, data_info, device)
        _refuse_regression(cfg, self.NAME)

    def loss(self, ctx: StepCtx) -> LossOut:
        out = ctx.model(ctx.batch["x_lb"], train=True,
                        generator=ctx.generator)
        sup_loss = self.ce_loss(out["logits"], ctx.batch["y_lb"],
                                reduction="mean")
        fwd = C.ForwardOut(out["logits"], out["logits"], out["logits"],
                           out["feat"], out["feat"], out["feat"])
        return self.pack(sup_loss=sup_loss,
                         unsup_loss=torch.zeros((), device=sup_loss.device),
                         fwd=fwd, new_algo_state=ctx.algo_state,
                         lambda_u=0.0)


@ALGORITHMS.register("pseudolabel")
class PseudoLabel(Algorithm):
    NAME = "pseudolabel"
    DEFAULTS = {"p_cutoff": 0.95, "unsup_warm_up": 0.4}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w")

    def __init__(self, cfg, data_info=None, device=None):
        super().__init__(cfg, data_info, device)
        _refuse_regression(cfg, self.NAME)

    def loss(self, ctx: StepCtx) -> LossOut:
        b = ctx.batch
        out_lb = ctx.model(b["x_lb"], train=True, generator=ctx.generator)
        with frozen_bn(ctx.model):
            out_ulb = ctx.model(b["x_ulb_w"], train=True,
                                generator=ctx.generator)
        logits_ulb = out_ulb["logits"]
        probs = self.maybe_dist_align(self.compute_prob(logits_ulb.detach()))
        sup_loss = self.ce_loss(out_lb["logits"], b["y_lb"],
                                reduction="mean")
        mask = self.fixed_mask(probs)
        pseudo_label = self.gen_ulb_targets(logits_ulb, use_hard_label=True)
        unsup_loss = self.consistency_loss(logits_ulb, pseudo_label, "ce",
                                           mask=mask)
        fwd = C.ForwardOut(out_lb["logits"], logits_ulb, logits_ulb,
                           out_lb["feat"], out_ulb["feat"], out_ulb["feat"])
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=ctx.algo_state, mask=mask,
                         pseudo_label=pseudo_label,
                         warmup=self.unsup_warmup_factor(ctx.step))
