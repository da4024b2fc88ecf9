"""Adsh (port of ``semireward_tpu/imb/adsh.py``): per-class adaptive
thresholds ``s``; the mask is ``max prob >= exp(-s[pred])``; at every epoch
end ``s`` is refit from the sorted per-class confidences of a full
unlabeled forward. FixMatch only."""
from __future__ import annotations

import numpy as np
import torch

from semireward_tpu_torch.imb.base import (ImbAlgorithm, predict_ulb_logits,
                                           softmax_np)
from semireward_tpu_torch.registry import IMB_ALGORITHMS


def refit_thresholds(logits: np.ndarray, s: np.ndarray, tau_1: float
                     ) -> np.ndarray:
    """The reference's ``update_s``: rho from class 0's sorted confidences
    above ``tau_1``, then each class's ``s`` from its own at that rank."""
    probs = softmax_np(logits)
    conf, pred = probs.max(-1), probs.argmax(-1)
    per_cls = [np.sort(conf[pred == y])[::-1] for y in range(len(s))]
    s = s.copy()
    if len(per_cls[0]) > 0:
        rho = 1.0
        for i in range(len(per_cls[0])):
            if per_cls[0][i] < tau_1:
                break
            rho = i / len(per_cls[0])
        for k in range(len(s)):
            if len(per_cls[k]) != 0:
                j = int(len(per_cls[k]) * rho) - 1
                s[k] = -np.log(per_cls[k][j])
    return s


@IMB_ALGORITHMS.register("adsh")
class Adsh(ImbAlgorithm):
    NAME = "adsh"
    DEFAULTS = {"adsh_tau_1": 0.95}
    SUPPORTED_BASES = ("fixmatch",)

    @property
    def tau_1(self) -> float:
        return float(self.cfg.extra.get("adsh_tau_1", 0.95))

    def init_imb_state(self):
        return {"adsh_s": torch.full((self.cfg.num_classes,), self.tau_1,
                                     device=self.device)}

    def override_names(self):
        return ("fixed_mask",)

    def imb_fixed_mask(self, probs):
        max_probs, pred = probs.max(-1)
        s = self._imb_state["adsh_s"]
        return (max_probs >= torch.exp(-s[pred])).to(probs.dtype)

    def on_epoch_end(self, trainer, state):
        base_state, imb_state = state.algo
        s_old = imb_state["adsh_s"]
        s = refit_thresholds(predict_ulb_logits(trainer),
                             s_old.cpu().numpy().astype(np.float32),
                             self.tau_1)
        state.algo = (base_state, {"adsh_s": torch.as_tensor(
            s.astype(np.float32), device=s_old.device)})
        return state
