"""SemiReward (port of ``semireward_tpu/algorithms/semireward.py``).

One wrapper, :class:`SemiRewardWrapper`, composes the reward model with a
base algorithm; ``srpseudolabel``, ``srfixmatch``, ``srflexmatch``,
``srfreematch`` and ``srsoftmatch`` are registered here, and
``_make_sr_variant`` registers it over any other registered algorithm
(a base that returns its forward and pseudo-labels). The base's warm-up
(Dash's) runs through the wrapper: the trainer reads ``base.NEEDS_WARMUP``
and ``set_rho_init`` passes to the base.

- The ``Rewarder`` keeps the reference's batch-dim "cross-attention": one
  softmax over the ``[2B, 128]`` concat of projected features and label
  embeddings, summed to a single vector added to every label embedding.
  With ``sr_per_sample`` (the JAX package's opt-in, beyond the reference)
  the softmax runs over each sample's own (feature, label) pair instead,
  and the rewarder trains in both stages on the labeled batch twice, with
  the true labels and with labels drawn uniformly (``draw_candidates``).
- Two stages keyed on ``start_timing``, with the JAX package's two
  conditions as written: the loss applies the reward filter
  (``mask2 = reward >= mean``) for ``step > start_timing``; ``sr_update``
  trains the rewarder on labeled data every step before ``start_timing`` and,
  from ``step >= start_timing`` on, tracks the max reward and trains on the
  unlabeled batch every ``N_k`` steps once ``step > start_timing``.
- The generator's parameters never move (its output is cast to int).
- In stage 2 the base algorithm's masking hook is applied again, as the
  reference's data generator does: ``sr_decay(step)`` times for FreeMatch
  and SoftMatch, whose hooks move EMA statistics. With the weak-view
  probabilities fixed, each statistic moves linearly toward a fixed
  target, so the repeats run in closed form (``common.ema_repeat``: a few
  launches, however many repeats). SoftMatch re-applies only its weighting,
  not the distribution alignment, on the raw weak probabilities.
- ``extra['sr_reforward'] = n > 1`` (the JAX bench's reference-equivalent
  arm; the JAX loss reads ``extra`` only, not the config field of that
  name) runs the reference's redundant stage-2 work: ``n - 1`` re-forwards
  of the whole batch without gradient, each remasked once and scored by
  the rewarder, then one last re-forward that the loss differentiates.
  Each re-forward replays the generator from before the base forward, so
  all draw its dropout and drop-path masks, as JAX's share one key, and
  the last one's logits equal the base forward's. BatchNorm's running
  statistics stay where the base forward left them.
- On a mesh (``parallel/mesh.py``) the reward filter and the rewarder
  read the global batch, as JAX's one program does: the weak features
  and pseudo labels of every batch rank are all-gathered (no gradient),
  the rewarder scores them all (its softmax runs over the batch), and
  each rank keeps its rows of ``mask2 = reward >= mean``; the rewarder and
  generator train on the gathered features and labels, the same update on
  every rank, so nothing of the SemiReward state is synced.
- A regression task (``num_classes`` 1, SRPseudoLabel) keeps the JAX
  package's arithmetic: the stage-2 consistency is L1; the one-column
  pseudo label's ``argmax`` makes every sample's pseudo class 0, so every
  sample takes one reward and the filter keeps all of them; stage 1's
  target compares one-hots over ``extra['range']`` (100) values of the
  truncated label. ``sr_per_sample`` raises ``ValueError`` there.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from semireward_tpu_torch import rng
from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx
from semireward_tpu_torch.core.losses import consistency_loss
from semireward_tpu_torch.core.optim import build_adam
from semireward_tpu_torch.core.train_state import SRState
from semireward_tpu_torch.models.batchnorm import frozen_bn
from semireward_tpu_torch.models.initializers import init_module_
from semireward_tpu_torch.parallel import mesh as mesh_lib
from semireward_tpu_torch.registry import ALGORITHMS


def label_dim(x: int, default_dim: int = 100) -> int:
    return int(max(default_dim, x))


def _one_hot(x, n: int):
    """jax.nn.one_hot: an index outside [0, n) gives an all-zero row."""
    return (x.long().unsqueeze(-1) == torch.arange(n, device=x.device)).float()


def cosine_similarity_n(x, y):
    """Cosine similarity mapped to [0, 1], shape [B, 1]."""
    eps = 1e-8
    num = (x * y).sum(-1)
    den = (torch.linalg.vector_norm(x, dim=-1).clamp(min=eps)
           * torch.linalg.vector_norm(y, dim=-1).clamp(min=eps))
    return ((num / den + 1.0) / 2.0).reshape(x.shape[0], 1)


class Generator(nn.Module):
    """Fake-label generator MLP; the output passes a final ReLU."""

    def __init__(self, feature_dim: int = 384):
        super().__init__()
        dims = (feature_dim, 256, 128, 64, 1)
        for i in range(4):
            self.add_module(f"fc{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        x = x.float()
        for i in range(4):
            x = getattr(self, f"fc{i}")(x)
            if i < 3:
                x = F.relu(x)
        return F.relu(x)


class Rewarder(nn.Module):
    """Pseudo-label reward model: the reference's faithful form, or with
    ``per_sample`` a softmax over each sample's own (feature, label) pair;
    the same parameters either way."""

    def __init__(self, label_dim: int, label_embedding_dim: int = 128,
                 feature_dim: int = 384, per_sample: bool = False):
        super().__init__()
        self.label_dim = label_dim
        self.per_sample = per_sample
        self.feature_fc = nn.Linear(feature_dim, 128)
        self.feature_norm = nn.LayerNorm(128, eps=1e-5)
        self.label_embedding = nn.Embedding(label_dim, label_embedding_dim)
        self.label_norm = nn.LayerNorm(label_embedding_dim, eps=1e-5)
        self.cross_attention_fc = nn.Linear(128, 1)
        self.mlp_fc1 = nn.Linear(128, 256)
        self.mlp_fc2 = nn.Linear(256, 128)
        self.ffn_fc1 = nn.Linear(128, 64)
        self.ffn_fc2 = nn.Linear(64, 1)

    def forward(self, features, label_indices):
        labels = label_indices.long().clamp(0, self.label_dim - 1)
        f = self.feature_norm(self.feature_fc(features.float()))
        emb = self.label_norm(self.label_embedding(labels))
        if self.per_sample:
            pair = torch.stack([f, emb], dim=1)                   # [B, 2, 128]
            w = F.softmax(self.cross_attention_fc(pair), dim=1)   # [B, 2, 1]
            h = (w * pair).sum(1) + emb                           # [B, 128]
        else:
            cat = torch.cat([f, emb], dim=0)                      # [2B, 128]
            w = F.softmax(self.cross_attention_fc(cat), dim=0)    # [2B, 1]
            h = (w * cat).sum(0, keepdim=True) + emb              # [B, 128]
        h = self.mlp_fc2(F.relu(self.mlp_fc1(h)))
        h = F.relu(self.ffn_fc1(h))
        return torch.sigmoid(self.ffn_fc2(h))                     # [B, 1]


SR_DEFAULTS = {"start_timing": 20000, "feature_dim": 384, "sr_lr": 0.0005,
               "N_k": 10, "sr_ema": True, "sr_ema_m": 0.999}


def _check_sr_mode(cfg):
    if cfg.sr_per_sample and cfg.is_regression:
        raise ValueError(
            "sr_per_sample trains on one-hot class agreement; regression "
            "tasks keep the faithful (reference) rewarder mode")


def _build(module_cls, device, generator, *args):
    with torch.device("meta"):
        m = module_cls(*args)
    return init_module_(m.to_empty(device=device or "cpu"), generator)


def init_sr_state(cfg, device=None, generator=None) -> SRState:
    _check_sr_mode(cfg)
    rewarder = _build(Rewarder, device, generator,
                      label_dim(cfg.num_classes), 128, cfg.feature_dim,
                      cfg.sr_per_sample)
    gen = _build(Generator, device, generator, cfg.feature_dim)
    ema = ([p.detach().clone() for p in rewarder.parameters()]
           if cfg.sr_ema else None)
    max_reward = torch.full((), -float("inf"), device=device)
    return SRState(rewarder=rewarder,
                   rewarder_opt=build_adam(rewarder, cfg.sr_lr),
                   rewarder_ema=ema, generator=gen, max_reward=max_reward)


@torch.no_grad()
def score_pseudo_labels(sr_state: SRState, feats, labels):
    """(rewards [B, 1], keep_mask [B]) with the ``reward >= mean`` filter."""
    reward = sr_state.rewarder(feats, labels)
    keep = (reward >= reward.mean()).squeeze(-1).float()
    return reward, keep


def draw_candidates(y_lb, num_classes: int, generator=None):
    """``sr_per_sample``'s negative candidates: a label drawn uniformly
    from the classes for each labeled sample."""
    return rng.randint(0, num_classes, y_lb.shape, generator=generator,
                       device=y_lb.device)


def sr_decay(step: int, num_train_iter: int, max_sampling_time: int = 8) -> int:
    """int(max(max_sampling, 1 + T/it)), in float32 like the JAX version."""
    it = np.float32(max(step, 1))
    return max(max_sampling_time,
               int(np.float32(1.0) + np.float32(num_train_iter) / it))


class SemiRewardWrapper(Algorithm):
    BASE_CLS: type = None
    DEFAULTS: Dict[str, Any] = {}
    HAS_SR = True

    def __init__(self, cfg, data_info=None, device=None):
        super().__init__(cfg, data_info, device)
        _check_sr_mode(cfg)
        self.base = self.BASE_CLS(cfg, data_info, device)
        self.BATCH_KEYS = tuple(dict.fromkeys(self.base.BATCH_KEYS
                                              + ("idx_ulb",)))

    def init_state(self):
        return self.base.init_state()

    def set_rho_init(self, algo_state, rho_init: float):
        """The base's warm-up result (Dash's ``rho_init``) into the base's
        state, which is this wrapper's."""
        return self.base.set_rho_init(algo_state, rho_init)

    def init_sr(self, generator=None) -> SRState:
        return init_sr_state(self.cfg, self.device, generator)

    def _remask(self, algo_state, probs_w, idx_ulb, n: int = 1):
        """The base algorithm's masking hook, re-applied as the reference's
        data generator does: once for the stateless hooks and FlexMatch's,
        ``n`` times on the same ``probs_w`` for FreeMatch's and SoftMatch's
        (the last state and mask kept). Any other base: its own
        ``remask(algo_state, probs_w, idx_ulb)`` where it defines one, else
        the fixed-threshold mask."""
        cfg = self.cfg
        name = self.base.NAME
        if name == "flexmatch":
            return C.flex_mask(algo_state, probs_w, idx_ulb, cfg.p_cutoff,
                               cfg.thresh_warmup)
        if name in ("freematch", "softmatch"):
            if name == "freematch":
                return C.free_mask(algo_state, probs_w, momentum=cfg.ema_p,
                                   use_quantile=cfg.use_quantile,
                                   clip_thresh=cfg.clip_thresh, repeat=n)
            g, mask = C.softmatch_mask(
                algo_state.gaussian, probs_w, n_sigma=cfg.n_sigma,
                momentum=cfg.ema_p, per_class=cfg.per_class, repeat=n)
            return algo_state._replace(gaussian=g), mask
        custom = getattr(self.base, "remask", None)
        if name not in ("fixmatch", "defixmatch", "pseudolabel") and custom:
            return custom(algo_state, probs_w, idx_ulb)
        return algo_state, C.fixed_threshold_mask(probs_w, cfg.p_cutoff)

    @staticmethod
    def _int_labels(pl):
        return pl if not pl.is_floating_point() else pl.argmax(-1)

    def _reforwards(self, ctx: StepCtx, replay, algo_state, probs_w,
                    pl_int) -> Tuple[Any, torch.Tensor, C.ForwardOut]:
        """``sr_reforward`` n > 1: the base remask once on the base
        forward's weak probabilities, then ``n - 1`` re-forwards without
        gradient, each remasked once and scored, then the last re-forward,
        differentiated. Returns the state and mask of the last remask and
        the last re-forward. Each re-forward starts from the generator
        state ``replay`` (taken before the base forward) and runs with
        BatchNorm frozen. The JAX package perturbs the loop's inputs by
        ``1 + i * 1e-45`` and the last one's by ``eps * 1e-45`` only so
        that XLA cannot hoist or drop the forwards; eager PyTorch does
        neither, and the batch goes in as it is. That is the same function:
        ``1 + i * 1e-45 == 1`` in float32, and ``x + eps * 1e-45`` differs
        from ``x`` only where ``x == 0``, by a float32 denormal that the
        bf16 patch embedding rounds away (token ids get an exact 0)."""
        cfg, b, idx_ulb = self.cfg, ctx.batch, ctx.batch.get("idx_ulb")
        n_ref = int(cfg.extra.get("sr_reforward", 1))
        gen = ctx.generator

        def reforward():
            if gen is not None:
                gen.set_state(replay)
            with frozen_bn(ctx.model):
                return C.ssl_forward(ctx.model, b["x_lb"], b["x_ulb_w"],
                                     b["x_ulb_s"], gen, train=True,
                                     use_cat=cfg.use_cat)

        algo_state, mask = self._remask(algo_state, probs_w, idx_ulb)
        with torch.no_grad():
            for _ in range(n_ref - 1):
                f = reforward()
                algo_state, mask = self._remask(
                    algo_state, C.compute_prob(f.logits_x_ulb_w), idx_ulb)
                # the reference scores every iteration; nothing reads it
                ctx.sr_state.rewarder(f.feats_x_ulb_w, pl_int)
        return algo_state, mask, reforward()

    def loss(self, ctx: StepCtx) -> LossOut:
        cfg = self.cfg
        reforward = (ctx.step > cfg.start_timing
                     and int(cfg.extra.get("sr_reforward", 1)) > 1)
        replay = (ctx.generator.get_state()
                  if reforward and ctx.generator is not None else None)
        base_out = self.base.loss(ctx)
        if ctx.step <= cfg.start_timing:
            ones = torch.ones((), device=base_out.total_loss.device)
            metrics = dict(base_out.metrics, sr_keep_ratio=ones)
            return base_out._replace(metrics=metrics)
        fwd = base_out.fwd
        probs_w = C.compute_prob(fwd.logits_x_ulb_w.detach())
        pl = base_out.pseudo_label
        pl_int = self._int_labels(pl)
        if reforward:
            algo_state, mask_dg, f = self._reforwards(
                ctx, replay, base_out.new_algo_state, probs_w, pl_int)
            logits_s, feats_w = f.logits_x_ulb_s, f.feats_x_ulb_w
        else:
            algo_state, mask_dg = self._remask(
                base_out.new_algo_state, probs_w, ctx.batch.get("idx_ulb"),
                sr_decay(ctx.step, cfg.num_train_iter, cfg.sr_max_sampling))
            logits_s, feats_w = fwd.logits_x_ulb_s, fwd.feats_x_ulb_w
        with torch.no_grad():
            reward = ctx.sr_state.rewarder(
                C.concat_all_gather(feats_w.detach()),
                C.concat_all_gather(pl_int))
        mask2 = (reward >= reward.mean()).squeeze(-1).float()
        mesh = mesh_lib.active()
        if mesh is not None:
            mask2 = mesh_lib.local_rows(mask2, mesh)
        # PseudoLabel has no strong view: its logits_x_ulb_s are the ulb
        # logits of its second forward; on a regression task its
        # consistency is L1
        lname = ("l1" if self.base.NAME == "pseudolabel"
                 and cfg.is_regression else "ce")
        unsup = consistency_loss(logits_s, pl, lname, mask=mask_dg,
                                 mask2=mask2)
        total = (base_out.total_loss
                 + base_out.unsup_weight * (unsup - base_out.unsup_loss))
        metrics = dict(base_out.metrics, total_loss=total, unsup_loss=unsup,
                       sr_keep_ratio=mask2.mean())
        return base_out._replace(total_loss=total, unsup_loss=unsup,
                                 new_algo_state=algo_state, metrics=metrics)

    # ---- SR online training (after the model's optimizer step) -----------
    def _train_rewarder(self, sr: SRState, feats, labels, target) -> None:
        params = list(sr.rewarder.parameters())
        with torch.enable_grad():
            reward = sr.rewarder(feats, labels)
            loss = (torch.mean((reward - 1.0) ** 2)
                    + torch.mean((reward - target) ** 2))
            grads = torch.autograd.grad(loss, params)
        sr.rewarder_opt.step(grads)

    @torch.no_grad()
    def _gen_labels(self, sr: SRState, feats):
        ldim = label_dim(self.cfg.num_classes)
        g = sr.generator(feats)
        return g.to(torch.int32).clamp(0, ldim - 1).squeeze(-1).long()

    def _train_per_sample(self, sr: SRState, feats_lb, y_lb,
                          generator) -> None:
        """``sr_per_sample``'s rewarder step: the labeled batch twice, with
        candidates ``[y_lb, drawn]`` and targets their agreement with
        ``y_lb`` (1, or 0.5 for another class); no ``reward -> 1`` term."""
        n_cls = self.cfg.num_classes
        cands = torch.cat([y_lb, draw_candidates(y_lb, n_cls, generator)])
        target = cosine_similarity_n(_one_hot(cands, n_cls),
                                     _one_hot(torch.cat([y_lb, y_lb]), n_cls))
        feats2 = torch.cat([feats_lb, feats_lb])
        params = list(sr.rewarder.parameters())
        with torch.enable_grad():
            loss = torch.mean((sr.rewarder(feats2, cands) - target) ** 2)
            grads = torch.autograd.grad(loss, params)
        sr.rewarder_opt.step(grads)

    @torch.no_grad()
    def sr_update(self, sr: SRState, out: LossOut, batch, step: int,
                  generator=None) -> Dict[str, torch.Tensor]:
        """Update ``sr`` in place for host step ``step``."""
        cfg = self.cfg
        n_cls = cfg.num_classes
        # the global batch on a mesh: every rank trains on the same rows
        gather = C.concat_all_gather
        feats_lb = gather(out.fwd.feats_x_lb.detach().float())
        feats_u = gather(out.fwd.feats_x_ulb_w.detach().float())
        pl_int = gather(self._int_labels(out.pseudo_label).long())
        y_lb = gather(batch["y_lb"].long())
        if step > 0 and step < cfg.start_timing:
            if cfg.sr_per_sample:
                self._train_per_sample(sr, feats_lb, y_lb, generator)
            else:
                # a regression target is one-hot over extra['range'] (100)
                # integer values, truncated as JAX's astype(int32) does
                dim = (int(cfg.extra.get("range", 100)) if cfg.is_regression
                       else n_cls)
                glab = self._gen_labels(sr, feats_lb)
                target = cosine_similarity_n(
                    _one_hot(glab.clamp(0, dim - 1), dim),
                    _one_hot(y_lb.reshape(glab.shape).clamp(0, dim - 1),
                             dim))
                self._train_rewarder(sr, feats_lb, glab, target)
        elif step > 0:
            reward_mean = sr.rewarder(feats_u, pl_int).mean()
            new_max = torch.maximum(sr.max_reward, reward_mean)
            if step % cfg.N_k == 0 and step > cfg.start_timing:
                if cfg.sr_per_sample:
                    self._train_per_sample(sr, feats_lb, y_lb, generator)
                else:
                    glab = self._gen_labels(sr, feats_u)
                    target = cosine_similarity_n(
                        _one_hot(glab, n_cls),
                        _one_hot(pl_int.clamp(0, n_cls - 1), n_cls))
                    self._train_rewarder(sr, feats_u, glab, target)
                sr.max_reward = torch.full_like(new_max, -float("inf"))
            else:
                sr.max_reward = new_max
        if cfg.sr_ema and sr.rewarder_ema is not None:
            # one EMA update per rewarder forward, folded into decay**k
            k = (int(step > 0) + int(step >= cfg.start_timing)
                 + (sr_decay(step, cfg.num_train_iter, cfg.sr_max_sampling)
                    if step > cfg.start_timing else 0)
                 + int(step % cfg.N_k == 0 and step > cfg.start_timing))
            dk = float(np.float32(cfg.sr_ema_m) ** np.float32(k))
            params = list(sr.rewarder.parameters())
            torch._foreach_mul_(sr.rewarder_ema, dk)
            torch._foreach_add_(sr.rewarder_ema, params, alpha=1.0 - dk)
        return {"max_reward": sr.max_reward}


def _make_sr_variant(name: str, base_name: str):
    """Register ``name``: SemiReward over the registered algorithm
    ``base_name`` (any: a user's own included, as
    ``examples/custom_algorithm.py`` wraps ``mymatch``)."""
    base_cls = ALGORITHMS.get(base_name)

    class _SR(SemiRewardWrapper):
        NAME = name
        BASE_CLS = base_cls
        MESH_READY = getattr(base_cls, "MESH_READY", False)
        DEFAULTS = {**getattr(base_cls, "DEFAULTS", {}), **SR_DEFAULTS}

    _SR.__name__ = f"SR_{base_cls.__name__}"
    ALGORITHMS.register(_SR, name=name)
    return _SR


SRPseudoLabel = _make_sr_variant("srpseudolabel", "pseudolabel")
SRFixMatch = _make_sr_variant("srfixmatch", "fixmatch")
SRFlexMatch = _make_sr_variant("srflexmatch", "flexmatch")
SRFreeMatch = _make_sr_variant("srfreematch", "freematch")
SRSoftMatch = _make_sr_variant("srsoftmatch", "softmatch")
