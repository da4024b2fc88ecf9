"""FreeMatch (port of ``semireward_tpu/algorithms/freematch.py``):
self-adaptive thresholding (a global ``time_p`` and per-class ``p_model``
EMAs, the mask from the updated statistics) plus the self-adaptive
fairness loss, weighted by ``ent_loss_ratio``."""
from __future__ import annotations

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.registry import ALGORITHMS


@ALGORITHMS.register("freematch")
class FreeMatch(Algorithm):
    NAME = "freematch"
    DEFAULTS = {"hard_label": True, "T": 0.5, "ema_p": 0.999,
                "ent_loss_ratio": 0.01, "use_quantile": False,
                "clip_thresh": False}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s")

    def init_state(self):
        return C.free_init(self.cfg.num_classes, self.device)

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        fwd = self.forward(ctx)
        sup_loss = self.ce_loss(fwd.logits_x_lb, ctx.batch["y_lb"],
                                reduction="mean")
        probs_w = self.compute_prob(fwd.logits_x_ulb_w)
        new_state, mask = C.free_mask(ctx.algo_state, probs_w,
                                      momentum=cfg.ema_p,
                                      use_quantile=cfg.use_quantile,
                                      clip_thresh=cfg.clip_thresh)
        # the reference passes the raw weak logits (softmax inside)
        pseudo_label = self.gen_ulb_targets(
            fwd.logits_x_ulb_w, use_hard_label=cfg.hard_label, T=cfg.T,
            softmax=True)
        unsup_loss = self.consistency_loss(fwd.logits_x_ulb_s, pseudo_label,
                                           "ce", mask=mask)
        ent_loss = C.free_entropy_loss(mask, fwd.logits_x_ulb_s,
                                       new_state.p_model,
                                       new_state.label_hist)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=new_state,
                         extra_loss=cfg.ent_loss_ratio * ent_loss, mask=mask,
                         pseudo_label=pseudo_label,
                         metrics={"ent_loss": ent_loss,
                                  "time_p": new_state.time_p,
                                  "max_prob_mean": probs_w.max(-1).values
                                  .mean()})
