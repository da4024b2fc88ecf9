"""The training step (port of ``semireward_tpu/core/step.py``).

One call: algorithm loss -> backward -> optimizer step (in place) -> the
algorithm's ``post_param_update`` where it has one -> EMA of the weights ->
SemiReward rewarder update -> step + 1. The step count is a
host int; the only host/device traffic is the batch going in.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from semireward_tpu_torch.algorithms.base import Algorithm, StepCtx
from semireward_tpu_torch.core import optim as optim_lib
from semireward_tpu_torch.core.train_state import TrainState, tree_ema


def init_train_state(cfg, alg: Algorithm, model, builder=None,
                     generator: Optional[torch.Generator] = None) -> TrainState:
    """Optimizer, EMA shadow, algorithm and SemiReward state for ``model``
    (already initialized, on its device). ``builder`` carries the
    layer-decay grouping (``layer_id_fn``/``num_layers``)."""
    if cfg.extra.get("flat_optimizer", False):
        raise NotImplementedError("flat_optimizer is not ported yet "
                                  "(ROADMAP: flat_optimizer)")
    opt = optim_lib.build_optimizer(
        model, optim_name=cfg.optim, lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, layer_decay=cfg.layer_decay,
        num_training_steps=cfg.num_train_iter,
        num_warmup_steps=cfg.num_warmup_iter, clip_grad=cfg.grad_clip,
        layer_id_fn=getattr(builder, "layer_id_fn", None),
        num_layers=getattr(builder, "num_layers", 0))
    sr = alg.init_sr(generator) if getattr(alg, "HAS_SR", False) else None
    return TrainState(step=0, model=model,
                      ema=[p.detach().clone() for p in model.parameters()],
                      opt=opt, algo=alg.init_state(), sr=sr, rng=generator)


def make_train_step(cfg, alg: Algorithm) -> Callable:
    """``train_step(state, batch, generator) -> metrics``; updates ``state``
    in place. ``generator`` draws the step's drop-path masks."""
    if cfg.extra.get("bf16_grads", False):
        raise NotImplementedError("bf16_grads is not ported yet "
                                  "(ROADMAP: port A/Bs)")
    has_sr = getattr(alg, "HAS_SR", False)
    post_update = getattr(alg, "post_param_update", None)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        ctx = StepCtx(model=state.model, batch=batch, algo_state=state.algo,
                      generator=generator, step=state.step,
                      sr_state=state.sr, ema=state.ema)
        out = alg.loss(ctx)
        params = list(state.model.parameters())
        # parameters outside the graph (a frozen feature extractor) get a
        # zero gradient, as optax gives them: Adam's moments still decay
        # and AdamW's weight decay still shrinks them
        grads = torch.autograd.grad(out.total_loss, params, allow_unused=True,
                                    materialize_grads=True)
        state.opt.step(grads)
        state.algo = out.new_algo_state
        if post_update is not None:
            # a second optimizer over the same (unclipped) gradients, after
            # the main one and before the EMA (CoSSL's teacher head)
            names = [n for n, _ in state.model.named_parameters()]
            state.algo = post_update(dict(zip(names, params)),
                                     dict(zip(names, grads)), state.algo,
                                     state.step)
        tree_ema(state.ema, params, cfg.ema_m)
        metrics = {k: v.detach() for k, v in out.metrics.items()}
        if has_sr:
            metrics.update(alg.sr_update(state.sr, out, batch, state.step,
                                         generator))
        state.step += 1
        return metrics

    return train_step
