"""SoftMatch (port of ``semireward_tpu/algorithms/softmatch.py``):
truncated-Gaussian confidence weights from EMA (mu, var) of the max
probability, after an EMA distribution alignment toward the uniform
target. The pseudo labels come from the raw weak logits, not from the
aligned probabilities."""
from __future__ import annotations

from typing import Any, NamedTuple

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.registry import ALGORITHMS


class SoftMatchAlgoState(NamedTuple):
    gaussian: Any      # C.SoftMatchState
    dist_align: Any    # C.DistAlignEMAState


@ALGORITHMS.register("softmatch")
class SoftMatch(Algorithm):
    NAME = "softmatch"
    DEFAULTS = {"hard_label": True, "T": 0.5, "dist_align": True,
                "dist_uniform": True, "ema_p": 0.999, "n_sigma": 2,
                "per_class": False}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s")

    def init_state(self):
        cfg = self.cfg
        da, _ = C.dist_align_ema_init(cfg.num_classes,
                                      update_target=not cfg.dist_uniform,
                                      device=self.device)
        return SoftMatchAlgoState(
            gaussian=C.softmatch_init(cfg.num_classes, cfg.per_class,
                                      self.device),
            dist_align=da)

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        fwd = self.forward(ctx)
        sup_loss = self.ce_loss(fwd.logits_x_lb, ctx.batch["y_lb"],
                                reduction="mean")
        probs_w = self.compute_prob(fwd.logits_x_ulb_w)
        da_state = ctx.algo_state.dist_align
        if cfg.dist_align:
            probs_lb = (None if cfg.dist_uniform
                        else self.compute_prob(fwd.logits_x_lb))
            da_state, probs_w = C.dist_align_ema(
                da_state, probs_w, probs_x_lb=probs_lb, momentum=cfg.ema_p,
                update_target=not cfg.dist_uniform)
        g_state, mask = C.softmatch_mask(ctx.algo_state.gaussian, probs_w,
                                         n_sigma=cfg.n_sigma,
                                         momentum=cfg.ema_p,
                                         per_class=cfg.per_class)
        pseudo_label = self.gen_ulb_targets(
            fwd.logits_x_ulb_w, use_hard_label=cfg.hard_label, T=cfg.T,
            softmax=True)
        unsup_loss = self.consistency_loss(fwd.logits_x_ulb_s, pseudo_label,
                                           "ce", mask=mask)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=SoftMatchAlgoState(g_state, da_state),
                         mask=mask, pseudo_label=pseudo_label)
