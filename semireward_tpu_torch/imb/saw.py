"""SAW (port of ``semireward_tpu/imb/saw.py``): class weights from
effective numbers. The labeled weights are fixed from the labeled split;
the unlabeled ones are refit at every epoch end from the pseudo-label
counts of a full unlabeled forward. The weighted CE (always a mean) and
consistency loss (weights folded into the mask) replace the base's."""
from __future__ import annotations

import numpy as np
import torch

from semireward_tpu_torch.core.losses import ce_loss, consistency_loss
from semireward_tpu_torch.imb.base import ImbAlgorithm, predict_ulb_logits
from semireward_tpu_torch.registry import IMB_ALGORITHMS


def effective_weights(y_cnt) -> np.ndarray:
    """``(1 - beta) / (1 - beta^n_c)``, normalized to sum to the number of
    classes, with ``beta = (N - 1) / N`` and N the mean count (float64)."""
    y_cnt = np.asarray(y_cnt, np.float64)
    N = y_cnt.sum() / len(y_cnt)
    beta = (N - 1) / N
    w = (1.0 - beta) / (1.0 - np.power(beta, y_cnt))
    return w / w.sum() * len(y_cnt)


def _hard(targets):
    return targets if not targets.is_floating_point() else targets.argmax(-1)


@IMB_ALGORITHMS.register("saw")
class SAW(ImbAlgorithm):
    NAME = "saw"

    def init_imb_state(self):
        num_ulb = self.data_info.get("ulb_dest_len", 1)
        C = self.cfg.num_classes
        return {"x_lb_weights": self._const(effective_weights(
                    self.lb_class_counts())),
                "x_ulb_weights": self._const(effective_weights(
                    np.full(C, num_ulb / C)))}

    def override_names(self):
        return ("ce_loss", "consistency_loss")

    def imb_ce_loss(self, logits, targets, reduction="none"):
        w = self._imb_state["x_lb_weights"][_hard(targets)]
        return (ce_loss(logits, targets) * w).mean()

    def imb_consistency_loss(self, logits, targets, name="ce", mask=None,
                             mask2=None):
        w = self._imb_state["x_ulb_weights"][_hard(targets)]
        return consistency_loss(logits, targets, name,
                                w if mask is None else mask * w, mask2)

    def on_epoch_end(self, trainer, state):
        counts = np.bincount(predict_ulb_logits(trainer).argmax(-1),
                             minlength=self.cfg.num_classes)
        base_state, imb_state = state.algo
        w = effective_weights(np.maximum(counts, 1))
        state.algo = (base_state, {
            **imb_state, "x_ulb_weights": torch.as_tensor(
                w.astype(np.float32), device=imb_state["x_ulb_weights"].device)})
        return state
