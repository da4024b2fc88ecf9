"""MixMatch (port of ``semireward_tpu/algorithms/mixmatch.py``): two weak
views forwarded without gradient give an averaged, sharpened target; MixUp
over the concatenated batch (``is_bias``); the mixed batch classified in
chunks of ``num_lb`` rows; CE on the mixed labeled rows and MSE on the
mixed unlabeled ones, ramped by ``unsup_warm_up``.

- Input space (images, waveforms): the inputs are mixed and each chunk is
  forwarded, only the first one updating the BatchNorm running statistics
  (every other forward normalizes by its own batch and leaves them). The
  JAX loss's forward of the labeled view feeds no loss and is not run.
- Feature space (``mixup_manifold``, any net): the features of the
  labeled forward (with its gradient, the only one into the backbone) and
  of the two weak forwards are mixed, and each chunk goes through the head
  alone (``only_fc``), so no chunk touches BatchNorm.

On token dicts the JAX loss mixes the inputs with ``jnp.concatenate`` and
fails unless ``mixup_manifold`` is set; the port refuses such a config when
it is built (``check_mixup_inputs``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.data.modality import modality_of
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.registry import ALGORITHMS


def sharpen(probs, T: float):
    p = probs ** (1 / T)
    return p / p.sum(-1, keepdim=True)


def check_mixup_inputs(cls, cfg) -> None:
    """MixMatch's and ReMixMatch's ``check_ported``: on a text net's token
    dicts the input-space MixUp cannot run (the JAX loss raises this
    ``TypeError`` from ``jnp.concatenate`` at its first step)."""
    if modality_of(cfg.net) == "nlp" and not cfg.mixup_manifold:
        raise TypeError(
            f"{cls.NAME} on {cfg.net} mixes token dicts: set mixup_manifold "
            f"to mix the features (the JAX package's input-space MixUp "
            f"fails on a dict)")


def chunk_logits(model, mixed_x, num_lb: int, generator,
                 only_fc: bool = False):
    """Logits of the mixed batch, ``num_lb`` rows at a time: features
    through the head alone (``only_fc``), or inputs forwarded with only the
    first chunk updating the BatchNorm running statistics."""
    logits = []
    for i, chunk in enumerate(torch.split(mixed_x, num_lb)):
        if only_fc:
            logits.append(model(chunk, only_fc=True))
            continue
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
    check_ported = classmethod(check_mixup_inputs)

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        b, model, gen = ctx.batch, ctx.model, ctx.generator
        num_lb = b["y_lb"].shape[0]
        manifold = cfg.mixup_manifold
        with frozen_bn(model):
            with torch.no_grad():
                outs_w1 = model(b["x_ulb_w"], train=True, generator=gen)
                outs_w2 = model(b["x_ulb_s"], train=True, generator=gen)
                target = sharpen((self.compute_prob(outs_w1["logits"])
                                  + self.compute_prob(outs_w2["logits"]))
                                 / 2, cfg.T)
            if manifold:
                outs_lb = model(b["x_lb"], train=True, generator=gen)
        if manifold:
            inputs = torch.cat([outs_lb["feat"], outs_w1["feat"],
                                outs_w2["feat"]])
        else:
            inputs = torch.cat([b["x_lb"], b["x_ulb_w"], b["x_ulb_s"]])
        labels = torch.cat([F.one_hot(b["y_lb"].long(),
                                      cfg.num_classes).float(),
                            target, target])
        lam, index = C.draw_mixup(inputs.shape[0], cfg.mixup_alpha, True,
                                  gen, inputs.device)
        mixed_x, mixed_y = C.mixup_one_target(inputs, labels, lam, index)
        logits_x, logits_u = chunk_logits(model, mixed_x, num_lb, gen,
                                          only_fc=manifold)
        sup_loss = self.ce_loss(logits_x, mixed_y[:num_lb], reduction="mean")
        unsup_loss = self.consistency_loss(logits_u, mixed_y[num_lb:], "mse")
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=None,
                         new_algo_state=ctx.algo_state,
                         warmup=self.unsup_warmup_factor(ctx.step))
