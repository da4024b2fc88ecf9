"""FlexMatch (port of ``semireward_tpu/algorithms/flexmatch.py``): FixMatch
with curriculum pseudo labeling; the full-ulb-set ``selected_label`` vector
lives on the device and updates by scatter + counts each step."""
from __future__ import annotations

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.registry import ALGORITHMS


@ALGORITHMS.register("flexmatch")
class FlexMatch(Algorithm):
    NAME = "flexmatch"
    MESH_READY = True
    DEFAULTS = {"hard_label": True, "T": 0.5, "p_cutoff": 0.95,
                "thresh_warmup": True}
    BATCH_KEYS = ("x_lb", "y_lb", "idx_ulb", "x_ulb_w", "x_ulb_s")

    def init_state(self):
        return C.flex_init(self.data_info["ulb_dest_len"],
                           self.cfg.num_classes, self.device)

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        fwd = self.forward(ctx)
        sup_loss = self.ce_loss(fwd.logits_x_lb, ctx.batch["y_lb"],
                                reduction="mean")
        probs_w = self.maybe_dist_align(self.compute_prob(fwd.logits_x_ulb_w))
        new_state, mask = C.flex_mask(ctx.algo_state, probs_w,
                                      ctx.batch["idx_ulb"], cfg.p_cutoff,
                                      cfg.thresh_warmup)
        pseudo_label = self.gen_ulb_targets(
            probs_w, use_hard_label=cfg.hard_label, T=cfg.T, softmax=False)
        unsup_loss = self.consistency_loss(fwd.logits_x_ulb_s, pseudo_label,
                                           "ce", mask=mask)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=new_state, mask=mask,
                         pseudo_label=pseudo_label)
