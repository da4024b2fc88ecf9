"""UDA (port of ``semireward_tpu/algorithms/uda.py``): a fixed threshold on
the weak view's probabilities, soft (unsharpened) pseudo labels, and
Training Signal Annealing (TSA) masking of the supervised CE."""
from __future__ import annotations

import numpy as np

from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.registry import ALGORITHMS


def tsa_threshold(schedule: str, step: int, total_iter: int,
                  num_classes: int) -> float:
    """The TSA threshold at ``step``, in float32 arithmetic like the JAX
    package's (a host float: the step is a host int)."""
    f32 = np.float32
    if schedule == "none":
        return 1.0
    progress = f32(step) / f32(total_iter)
    if schedule == "linear":
        thr = progress
    elif schedule == "exp":
        thr = np.exp((progress - f32(1.0)) * f32(5.0))
    elif schedule == "log":
        thr = f32(1.0) - np.exp(-progress * f32(5.0))
    else:
        raise ValueError(f"unknown tsa schedule {schedule}")
    return float(thr * (f32(1.0) - f32(1.0) / f32(num_classes))
                 + f32(1.0) / f32(num_classes))


@ALGORITHMS.register("uda")
class UDA(Algorithm):
    NAME = "uda"
    DEFAULTS = {"tsa_schedule": "none", "T": 0.4, "p_cutoff": 0.8}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s")

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        fwd = self.forward(ctx)
        tsa = tsa_threshold(cfg.tsa_schedule, ctx.step, cfg.num_train_iter,
                            cfg.num_classes)
        probs_lb = self.compute_prob(fwd.logits_x_lb.detach())
        sup_mask = (probs_lb.max(-1).values <= tsa).float()
        sup_loss = (self.ce_loss(fwd.logits_x_lb, ctx.batch["y_lb"])
                    * sup_mask).mean()
        probs_w = self.maybe_dist_align(self.compute_prob(fwd.logits_x_ulb_w))
        mask = self.fixed_mask(probs_w)
        # soft pseudo labels: the probabilities pass through unsharpened
        pseudo_label = self.gen_ulb_targets(probs_w, use_hard_label=False,
                                            T=cfg.T, softmax=False)
        unsup_loss = self.consistency_loss(fwd.logits_x_ulb_s, pseudo_label,
                                           "ce", mask=mask)
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=ctx.algo_state, mask=mask,
                         pseudo_label=pseudo_label)
