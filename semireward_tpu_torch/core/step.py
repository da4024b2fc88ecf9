"""The training step (port of ``semireward_tpu/core/step.py``).

One call: algorithm loss -> backward -> optimizer step (in place) -> the
algorithm's ``post_param_update`` where it has one -> EMA of the weights ->
SemiReward rewarder update -> step + 1. The step count is a
host int; the only host/device traffic is the batch going in.

On a mesh (``init_train_state(..., mesh=)``, ``parallel/mesh.py``) the state
takes the mesh's layout (``Layout``: FSDP leaves as their shard, TP leaves
as their block, for the parameters, the EMA and the optimizer moments).
Each rank's step runs on its rows: the FSDP leaves are gathered around the
loss and its gradient, the loss is divided by the number of batch shards,
the gradients are summed over the batch ranks and cut to this rank's
blocks (``Layout.sync``), the optimizer (its global-norm clip over every
block) and the EMA run on the blocks, and the logged means are averaged
over the batch ranks. The result is the one-process step on the
concatenated global batch, as the JAX package's mesh step is.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from semireward_tpu_torch.algorithms.base import Algorithm, StepCtx
from semireward_tpu_torch.core import optim as optim_lib
from semireward_tpu_torch.core.train_state import TrainState, tree_ema
from semireward_tpu_torch.parallel import mesh as mesh_lib


def init_train_state(cfg, alg: Algorithm, model, builder=None,
                     generator: Optional[torch.Generator] = None,
                     mesh=None, fsdp_min_size: int = 2 ** 16) -> TrainState:
    """Optimizer, EMA shadow, algorithm and SemiReward state for ``model``
    (already initialized, on its device). ``builder`` carries the
    layer-decay grouping (``layer_id_fn``/``num_layers``). With ``mesh``
    the parameters are first cut to this rank's blocks (the JAX package's
    layout for the mesh; ``fsdp_min_size`` its FSDP size gate), and the EMA
    shadow and the moments are made from the blocks."""
    if cfg.extra.get("flat_optimizer", False):
        raise NotImplementedError("flat_optimizer is not ported yet "
                                  "(ROADMAP: flat_optimizer)")
    layout = None
    if mesh is not None:
        layout = mesh_lib.Layout(mesh, model, fsdp_min_size)
        layout.shard_()
    opt = optim_lib.build_optimizer(
        model, optim_name=cfg.optim, lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, layer_decay=cfg.layer_decay,
        num_training_steps=cfg.num_train_iter,
        num_warmup_steps=cfg.num_warmup_iter, clip_grad=cfg.grad_clip,
        layer_id_fn=getattr(builder, "layer_id_fn", None),
        num_layers=getattr(builder, "num_layers", 0))
    if layout is not None:
        opt.sq_norm_fn = layout.sq_norm
    sr = alg.init_sr(generator) if getattr(alg, "HAS_SR", False) else None
    return TrainState(step=0, model=model,
                      ema=[p.detach().clone() for p in model.parameters()],
                      opt=opt, algo=alg.init_state(), sr=sr, rng=generator,
                      layout=layout)


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
        layout = state.layout
        params = list(state.model.parameters())
        if layout is not None:
            layout.gather_()
        try:
            out = alg.loss(ctx)
            loss = out.total_loss
            if layout is not None:
                # each rank's share of the global mean: the sum of every
                # rank's gradient is the global batch's
                loss = loss / layout.mesh.batch_shards
            # parameters outside the graph (a frozen feature extractor) get
            # a zero gradient, as optax gives them: Adam's moments still
            # decay and AdamW's weight decay still shrinks them
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        finally:
            if layout is not None:
                layout.release_()
        if layout is not None:
            grads = layout.sync(grads)
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
        if layout is not None:
            # the logged means over the global batch
            keys = [k for k, v in metrics.items() if v.ndim == 0]
            metrics.update(zip(keys, mesh_lib.global_mean_(
                [metrics[k] for k in keys], layout.mesh)))
        if has_sr:
            metrics.update(alg.sr_update(state.sr, out, batch, state.step,
                                         generator))
        state.step += 1
        return metrics

    return train_step
