"""AdaMatch (port of ``semireward_tpu/algorithms/adamatch.py``):
distribution alignment toward an EMA of the labeled probabilities
(``update_target``), and a relative confidence threshold (the labeled
batch's mean max probability times ``p_cutoff``)."""
from __future__ import annotations

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.registry import ALGORITHMS


@ALGORITHMS.register("adamatch")
class AdaMatch(Algorithm):
    NAME = "adamatch"
    DEFAULTS = {"hard_label": True, "T": 0.5, "ema_p": 0.999,
                "p_cutoff": 0.95}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s")

    def init_state(self):
        return C.dist_align_ema_init(self.cfg.num_classes, update_target=True,
                                     device=self.device)[0]

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        fwd = self.forward(ctx)
        sup_loss = self.ce_loss(fwd.logits_x_lb, ctx.batch["y_lb"],
                                reduction="mean")
        probs_lb = self.compute_prob(fwd.logits_x_lb.detach())
        new_state, probs_w = C.dist_align_ema(
            ctx.algo_state, self.compute_prob(fwd.logits_x_ulb_w),
            probs_x_lb=probs_lb, momentum=cfg.ema_p, update_target=True)
        cutoff = probs_lb.max(-1).values.mean() * cfg.p_cutoff
        mask = (probs_w.max(-1).values >= cutoff).float()
        pseudo_label = self.gen_ulb_targets(
            probs_w, use_hard_label=cfg.hard_label, T=cfg.T, softmax=False)
        unsup_loss = self.consistency_loss(fwd.logits_x_ulb_s, pseudo_label,
                                           "ce", mask=mask)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=new_state, mask=mask,
                         pseudo_label=pseudo_label)
