"""DebiasPL (port of ``semireward_tpu/imb/debiaspl.py``): the marginal
``p_hat`` debiases ``compute_prob`` (``logits - tau * log p_hat``) and
re-biases the consistency logits (``+ tau * log p_hat``). As in the
reference and the JAX package, the EMA mixes with ``ema_m`` (the model
EMA's decay) and scales the innovation by ``1 - debiaspl_ema_p``; every
``compute_prob`` call of the step chains one update, and the consistency
loss reads the latest."""
from __future__ import annotations

import torch

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.core.losses import consistency_loss
from semireward_tpu_torch.imb.base import ImbAlgorithm
from semireward_tpu_torch.registry import IMB_ALGORITHMS


@IMB_ALGORITHMS.register("debiaspl")
class DebiasPL(ImbAlgorithm):
    NAME = "debiaspl"
    DEFAULTS = {"debiaspl_tau": 0.4, "debiaspl_ema_p": 0.999}
    UNSUPPORTED_BASES = ("mixmatch", "meanteacher", "pimodel")

    @property
    def tau(self) -> float:
        return float(self.cfg.extra.get("debiaspl_tau", 0.4))

    @property
    def dbl_ema_p(self) -> float:
        return float(self.cfg.extra.get("debiaspl_ema_p", 0.999))

    def init_imb_state(self):
        n = self.cfg.num_classes
        return {"p_hat": torch.ones(n, device=self.device) / n}

    def override_names(self):
        return ("compute_prob", "consistency_loss")

    def _p_hat(self):
        return self._cell.get("p_hat", self._imb_state["p_hat"])

    def imb_compute_prob(self, logits):
        probs = C.compute_prob(logits)
        p_hat = (self.cfg.ema_m * self._p_hat()
                 + (1 - self.dbl_ema_p) * probs.mean(0)).detach()
        self._cell["p_hat"] = p_hat
        return C.compute_prob(logits - self.tau * torch.log(p_hat))

    def imb_consistency_loss(self, logits, targets, name="ce", mask=None,
                             mask2=None):
        return consistency_loss(
            logits.float() + self.tau * torch.log(self._p_hat()), targets,
            name, mask, mask2)

    def update_imb_state(self, imb_state, out, ctx):
        return {"p_hat": self._p_hat()}
