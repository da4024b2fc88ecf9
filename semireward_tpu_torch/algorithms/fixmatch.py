"""FixMatch and DeFixMatch (port of
``semireward_tpu/algorithms/fixmatch.py``): CE on the labeled view,
fixed-threshold hard pseudo labels from the weak view, CE consistency on the
strong view."""
from __future__ import annotations

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.registry import ALGORITHMS


@ALGORITHMS.register("fixmatch")
class FixMatch(Algorithm):
    NAME = "fixmatch"
    MESH_READY = True
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


@ALGORITHMS.register("defixmatch")
class DeFixMatch(FixMatch):
    """DeFixMatch: FixMatch plus a debiasing term, the same masked
    consistency loss on the labeled strong view against the labeled weak
    view's pseudo labels, subtracted. One pass over [x_lb, x_lb_s, x_ulb_w,
    x_ulb_s] with ``use_cat``."""

    NAME = "defixmatch"
    MESH_READY = False
    BATCH_KEYS = ("x_lb", "x_lb_s", "y_lb", "x_ulb_w", "x_ulb_s")

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        b = ctx.batch
        num_lb = b["y_lb"].shape[0]
        fwd = C.ssl_forward(ctx.model, C.cat_views(b["x_lb"], b["x_lb_s"]),
                            b["x_ulb_w"], b["x_ulb_s"], ctx.generator,
                            train=True, use_cat=cfg.use_cat)
        logits_x_lb = fwd.logits_x_lb[:num_lb]
        logits_x_lb_s = fwd.logits_x_lb[num_lb:]
        sup_loss = 0.5 * (
            self.ce_loss(logits_x_lb, b["y_lb"], reduction="mean")
            + self.ce_loss(logits_x_lb_s, b["y_lb"], reduction="mean"))
        probs_w_ulb = self.compute_prob(fwd.logits_x_ulb_w)
        probs_w_lb = self.compute_prob(logits_x_lb.detach())
        mask = self.fixed_mask(probs_w_ulb)
        mask_lb = self.fixed_mask(probs_w_lb)
        pl_ulb = self.gen_ulb_targets(probs_w_ulb, cfg.hard_label, cfg.T,
                                      softmax=False)
        anti_pl = self.gen_ulb_targets(probs_w_lb, cfg.hard_label, cfg.T,
                                       softmax=False)
        unsup_loss = self.consistency_loss(fwd.logits_x_ulb_s, pl_ulb, "ce",
                                           mask=mask)
        anti_unsup = self.consistency_loss(logits_x_lb_s, anti_pl, "ce",
                                           mask=mask_lb)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss - anti_unsup,
                         fwd=fwd, new_algo_state=ctx.algo_state, mask=mask,
                         pseudo_label=pl_ulb,
                         metrics={"anti_unsup_loss": anti_unsup,
                                  "util_ratio_lb": mask_lb.mean()})
