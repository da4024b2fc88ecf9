"""VAT, Virtual Adversarial Training (port of
``semireward_tpu/algorithms/vat.py``): one power iteration finds the
direction that moves the prediction most, as ``torch.autograd.grad`` of
the KL divergence through a tiny probe ``d``; the adversarial forward at
``vat_eps`` along it gives the consistency KL, plus an entropy penalty on
the unlabeled predictions. Every unlabeled forward runs with BatchNorm
frozen. The probed and the adversarial forwards draw the same dropout and
drop-path masks (the JAX package gives both one key): the generator's state
is replayed between them.

- Images and waveforms: the probe perturbs the input. The audio nets'
  feature extractor is frozen (the JAX model's ``stop_gradient``), so the
  gradient with respect to a waveform is exactly 0 and so is ``r_adv``
  (``6 * 0 / (0 + 1e-16)``): the port takes that zero without the probe's
  forward and backward, which the JAX program never runs either (its
  gradient is a symbolic zero), and the adversarial forward is the clean
  clip under the probe's dropout stream.
- Token dicts with ``vat_embed``: the probe perturbs the embedding
  LayerNorm's output of the unlabeled forward (``return_embed``), fed back
  as ``inputs_embeds``, which replaces the word embeddings only (the
  position and type embeddings and the LayerNorm apply again: the
  reference's quirk, kept by the JAX package). Without ``vat_embed`` the
  JAX loss reads a dict's ``shape`` and fails; the port refuses such a
  config when it is built."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from semireward_tpu_torch import rng
from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.data.modality import modality_of
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.registry import ALGORITHMS

XI = 1e-6  # the probe's norm


def l2_normalize(d):
    """Each sample of ``d`` scaled to unit l2 norm (1e-16 added to it)."""
    norm = d.pow(2).sum(tuple(range(1, d.ndim)), keepdim=True).sqrt()
    return d / (norm + 1e-16)


def kl_div_with_logit(q_logit, p_logit):
    """Mean over the batch of KL(softmax(q) || softmax(p))."""
    q = F.softmax(q_logit, dim=1)
    logq = F.log_softmax(q_logit, dim=1)
    logp = F.log_softmax(p_logit, dim=1)
    return ((q * logq).sum(1) - (q * logp).sum(1)).mean()


def entropy_loss(ul_y):
    p = F.softmax(ul_y, dim=1)
    return -(p * F.log_softmax(ul_y, dim=1)).sum(1).mean()


def draw_probe(x, generator=None):
    """The power iteration's start: ``XI * l2_normalize(N(0, 1))`` of
    ``x``'s shape, in float32."""
    d = rng.randn(x.shape, generator=generator, device=x.device)
    return XI * l2_normalize(d)


def perturbed_forward(model, x, tokens=None, generator=None):
    """The net at ``x``: the input itself, or with ``tokens`` the
    embeddings fed to the token dict as ``inputs_embeds``."""
    inp = x if tokens is None else {**tokens, "inputs_embeds": x}
    return model(inp, train=True, generator=generator)


def power_iteration(model, x, ul_y, d, generator=None, tokens=None):
    """Gradient of ``KL(ul_y || model(x + d))`` with respect to ``d``
    (detached; no parameter gradient is kept)."""
    d = d.detach().requires_grad_()
    out = perturbed_forward(model, x + d, tokens, generator)
    return torch.autograd.grad(kl_div_with_logit(ul_y, out["logits"]),
                               d)[0]


def adversarial_perturbation(model, x, ul_y, eps, generator=None,
                             tokens=None):
    """``(r_adv, grad_d)``: one power iteration from a drawn probe, and its
    gradient scaled to norm ``eps`` a sample. The generator's state is
    replayed after the probed forward, so the adversarial forward that
    follows draws the same masks (the JAX package gives both one key).
    On a net whose input gradient is exactly 0 (``input_grad_is_zero``:
    the audio nets' frozen extractor) ``grad_d`` is that zero, with no
    probed forward, and the adversarial forward draws what it would have
    drawn."""
    d = draw_probe(x, generator)
    if tokens is None and getattr(model, "input_grad_is_zero", False):
        grad_d = torch.zeros_like(d)
    else:
        replay = generator.get_state() if generator is not None else None
        grad_d = power_iteration(model, x, ul_y, d, generator, tokens)
        if replay is not None:
            generator.set_state(replay)
    return eps * l2_normalize(grad_d), grad_d


@ALGORITHMS.register("vat")
class VAT(Algorithm):
    NAME = "vat"
    DEFAULTS = {"ent_loss_ratio": 0.06, "vat_eps": 6.0, "vat_embed": False,
                "unsup_warm_up": 0.4}
    BATCH_KEYS = ("x_lb", "y_lb", "x_ulb_w")

    @classmethod
    def check_ported(cls, cfg) -> None:
        """On token dicts only the embedding form runs (the JAX loss's
        input-space probe raises this ``AttributeError`` at its first
        step); ``vat_embed`` on images or waveforms is ignored, as in the
        JAX package."""
        if modality_of(cfg.net) == "nlp" and not cfg.vat_embed:
            raise AttributeError(
                f"vat on {cfg.net} probes a token dict: set vat_embed to "
                f"perturb the word embeddings (the JAX package's input-space "
                f"probe reads the shape of a dict and fails)")

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        b, model, gen = ctx.batch, ctx.model, ctx.generator
        outs_lb = model(b["x_lb"], train=True, generator=gen)
        sup_loss = self.ce_loss(outs_lb["logits"], b["y_lb"],
                                reduction="mean")
        x_ulb = b["x_ulb_w"]
        tokens = x_ulb if cfg.vat_embed and isinstance(x_ulb, dict) else None
        with frozen_bn(model):
            outs_ulb = model(x_ulb, train=True, generator=gen,
                             **({} if tokens is None else
                                {"return_embed": True}))
            ul_y = outs_ulb["logits"].detach()
            x = x_ulb if tokens is None else outs_ulb["embed"].detach()
            r_adv, _ = adversarial_perturbation(model, x, ul_y, cfg.vat_eps,
                                                gen, tokens)
            out_adv = perturbed_forward(model, x + r_adv, tokens, gen)
        unsup_loss = kl_div_with_logit(ul_y, out_adv["logits"])
        loss_entmin = entropy_loss(outs_ulb["logits"])
        fwd = C.ForwardOut(outs_lb["logits"], outs_ulb["logits"],
                           out_adv["logits"], outs_lb["feat"],
                           outs_ulb["feat"], outs_ulb["feat"])
        return self.pack(sup_loss=sup_loss, unsup_loss=unsup_loss, fwd=fwd,
                         new_algo_state=ctx.algo_state,
                         warmup=self.unsup_warmup_factor(ctx.step),
                         extra_loss=cfg.ent_loss_ratio * loss_entmin,
                         metrics={"loss_entmin": loss_entmin})
