"""FixMatch (port of ``semireward_tpu/algorithms/fixmatch.py``): CE on the
labeled view, fixed-threshold hard pseudo labels from the weak view, CE
consistency on the strong view."""
from __future__ import annotations

from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.registry import ALGORITHMS


@ALGORITHMS.register("fixmatch")
class FixMatch(Algorithm):
    NAME = "fixmatch"
    DEFAULTS = {"hard_label": True, "T": 0.5, "p_cutoff": 0.95}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s")

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        fwd = self.forward(ctx)
        sup_loss = self.ce_loss(fwd.logits_x_lb, ctx.batch["y_lb"],
                                reduction="mean")
        probs_w = self.maybe_dist_align(self.compute_prob(fwd.logits_x_ulb_w))
        mask = self.fixed_mask(probs_w)
        pseudo_label = self.gen_ulb_targets(
            probs_w, use_hard_label=cfg.hard_label, T=cfg.T, softmax=False)
        unsup_loss = self.consistency_loss(fwd.logits_x_ulb_s, pseudo_label,
                                           "ce", mask=mask)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=ctx.algo_state, mask=mask,
                         pseudo_label=pseudo_label)
