"""MixMatch (port of ``semireward_tpu/algorithms/mixmatch.py``): two weak
views forwarded without gradient give an averaged, sharpened target; MixUp
over the concatenated batch (``is_bias``); forwards of the mixed batch in
chunks of ``num_lb`` rows, of which only the first updates the BatchNorm
running statistics (every other forward normalizes by its own batch and
leaves them); CE on the mixed labeled rows and MSE on the mixed unlabeled
ones, ramped by ``unsup_warm_up``. The JAX loss's forward of the labeled
view feeds no loss and is not run. The feature-space MixUp of the NLP and
audio nets (``mixup_manifold``) is not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import (Algorithm, LossOut,
                                                  StepCtx, not_ported,
                                                  text_audio_item)
from semireward_tpu_torch.data.modality import modality_of
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.registry import ALGORITHMS


def sharpen(probs, T: float):
    p = probs ** (1 / T)
    return p / p.sum(-1, keepdim=True)


def check_input_mixup(cls, cfg) -> None:
    """MixMatch's and ReMixMatch's ``check_ported``: the port mixes images;
    the feature-space MixUp (``mixup_manifold``, the text and audio nets')
    is not ported yet."""
    if cfg.mixup_manifold or modality_of(cfg.net) != "cv":
        not_ported(f"{cls.NAME}'s feature-space MixUp (mixup_manifold) on "
                   f"{cfg.net}", text_audio_item(cfg.net))


def chunk_logits(model, mixed_x, num_lb: int, generator):
    """Logits of the mixed batch, forwarded ``num_lb`` rows at a time; only
    the first chunk updates the BatchNorm running statistics."""
    logits = []
    for i, chunk in enumerate(torch.split(mixed_x, num_lb)):
        if i == 0:
            out = model(chunk, train=True, generator=generator)
        else:
            with frozen_bn(model):
                out = model(chunk, train=True, generator=generator)
        logits.append(out["logits"])
    return logits[0], torch.cat(logits[1:])


@ALGORITHMS.register("mixmatch")
class MixMatch(Algorithm):
    NAME = "mixmatch"
    DEFAULTS = {"T": 0.5, "unsup_warm_up": 1 / 64, "mixup_alpha": 0.5,
                "mixup_manifold": False}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w", "x_ulb_s")
    WEAK_ULB_S = True
    check_ported = classmethod(check_input_mixup)

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        b, model, gen = ctx.batch, ctx.model, ctx.generator
        num_lb = b["y_lb"].shape[0]
        with torch.no_grad(), frozen_bn(model):
            outs_w1 = model(b["x_ulb_w"], train=True, generator=gen)
            outs_w2 = model(b["x_ulb_s"], train=True, generator=gen)
            target = sharpen((self.compute_prob(outs_w1["logits"])
                              + self.compute_prob(outs_w2["logits"])) / 2,
                             cfg.T)
        inputs = torch.cat([b["x_lb"], b["x_ulb_w"], b["x_ulb_s"]])
        labels = torch.cat([F.one_hot(b["y_lb"].long(),
                                      cfg.num_classes).float(),
                            target, target])
        lam, index = C.draw_mixup(inputs.shape[0], cfg.mixup_alpha, True,
                                  gen, inputs.device)
        mixed_x, mixed_y = C.mixup_one_target(inputs, labels, lam, index)
        logits_x, logits_u = chunk_logits(model, mixed_x, num_lb, gen)
        sup_loss = self.ce_loss(logits_x, mixed_y[:num_lb], reduction="mean")
        unsup_loss = self.consistency_loss(logits_u, mixed_y[num_lb:], "mse")
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=None,
                         new_algo_state=ctx.algo_state,
                         warmup=self.unsup_warmup_factor(ctx.step))
