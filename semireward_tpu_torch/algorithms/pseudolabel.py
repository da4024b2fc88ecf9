"""Pseudo-Label and FullySupervised (port of
``semireward_tpu/algorithms/pseudolabel.py``).

PseudoLabel runs two forwards: the labeled view, and the unlabeled weak
view with BatchNorm frozen (normalized by its own batch moments, running
statistics left as they were: ``models/batchnorm.py:frozen_bn``). The
unsupervised CE back-propagates through the same unlabeled logits that
gave the (detached) hard pseudo labels, ramped by ``unsup_warm_up``.

On a regression task (``num_classes`` 1) the supervised loss is
``reg_loss`` and PseudoLabel runs three forwards: the labeled view, the
unlabeled weak view plus Gaussian noise of scale 0.05 (``draw_noise``;
with gradient) and the clean view, whose detached logits are the pseudo
label, both with BatchNorm frozen; the consistency is L1 under a mask of
ones. The JAX loss gives both unlabeled forwards one dropout key, so the
generator's state is replayed between them: the clean forward draws the
noisy one's masks.
"""
from __future__ import annotations

import torch

from semireward_tpu_torch import rng
from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.core.losses import reg_loss
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.registry import ALGORITHMS

NOISE_STD = 0.05


def draw_noise(x, generator=None):
    """PseudoLabel's regression perturbation: ``N(0, 1) * NOISE_STD`` of
    ``x``'s shape and dtype."""
    return rng.randn(x.shape, generator=generator, device=x.device,
                     dtype=x.dtype, rows=0) * NOISE_STD


@ALGORITHMS.register("fullysupervised")
@ALGORITHMS.register("supervised")
class FullySupervised(Algorithm):
    NAME = "fullysupervised"
    MESH_READY = True
    BATCH_KEYS = ("x_lb", "y_lb")

    def loss(self, ctx: StepCtx) -> LossOut:
        out = ctx.model(ctx.batch["x_lb"], train=True,
                        generator=ctx.generator)
        if self.cfg.is_regression:
            sup_loss = reg_loss(out["logits"], ctx.batch["y_lb"],
                                mode=self.cfg.reg_loss)
        else:
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
    MESH_READY = True
    DEFAULTS = {"p_cutoff": 0.95, "unsup_warm_up": 0.4}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w")

    def loss(self, ctx: StepCtx) -> LossOut:
        b, gen = ctx.batch, ctx.generator
        out_lb = ctx.model(b["x_lb"], train=True, generator=gen)
        if self.cfg.is_regression:
            noise = draw_noise(b["x_ulb_w"], gen)
            replay = gen.get_state() if gen is not None else None
            with frozen_bn(ctx.model):
                out_ulb = ctx.model(b["x_ulb_w"] + noise, train=True,
                                    generator=gen)
                if replay is not None:
                    gen.set_state(replay)
                with torch.no_grad():
                    pseudo_label = ctx.model(b["x_ulb_w"], train=True,
                                             generator=gen)["logits"]
            logits_ulb = out_ulb["logits"]
            sup_loss = reg_loss(out_lb["logits"], b["y_lb"])
            mask = torch.ones(logits_ulb.shape[0], device=logits_ulb.device)
            unsup_loss = self.consistency_loss(logits_ulb, pseudo_label, "l1",
                                               mask=mask)
        else:
            with frozen_bn(ctx.model):
                out_ulb = ctx.model(b["x_ulb_w"], train=True, generator=gen)
            logits_ulb = out_ulb["logits"]
            probs = self.maybe_dist_align(
                self.compute_prob(logits_ulb.detach()))
            sup_loss = self.ce_loss(out_lb["logits"], b["y_lb"],
                                    reduction="mean")
            mask = self.fixed_mask(probs)
            pseudo_label = self.gen_ulb_targets(logits_ulb,
                                                use_hard_label=True)
            unsup_loss = self.consistency_loss(logits_ulb, pseudo_label, "ce",
                                               mask=mask)
        fwd = C.ForwardOut(out_lb["logits"], logits_ulb, logits_ulb,
                           out_lb["feat"], out_ulb["feat"], out_ulb["feat"])
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=ctx.algo_state, mask=mask,
                         pseudo_label=pseudo_label,
                         warmup=self.unsup_warmup_factor(ctx.step))
