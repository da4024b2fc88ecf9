"""The imbalanced-SSL wrapper (port of ``semireward_tpu/imb/base.py``).

:class:`ImbAlgorithm` wraps an instance of a base algorithm. Its state is
``(base_state, imb_state)``. For the call of the base's ``loss`` it swaps
the hooks it names (``override_names``: ``ce_loss``, ``consistency_loss``,
``compute_prob``, ``gen_ulb_targets``, ``fixed_mask``,
``maybe_dist_align``) on the base instance for its own ``imb_<name>`` and
restores them after; the bases call these hooks as methods, so the swap
works eagerly. Then ``post_loss`` adds the wrapper's own terms and
``update_imb_state`` returns its new state. ``on_epoch_end(trainer,
state)`` is the host's work at an epoch boundary (a full unlabeled forward
for SAW and ADSH, ``predict_ulb_logits``). A wrapper over a SemiReward
variant is refused: the JAX package's wrapper carries no ``HAS_SR``, so
its step never trains the rewarder and its base loss reads a SemiReward
state that is ``None``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

from semireward_tpu_torch.algorithms.base import Algorithm, LossOut, StepCtx


class ImbAlgorithm(Algorithm):
    NAME = "imb_base"
    DEFAULTS: Dict[str, Any] = {}
    # the base algorithms this wrapper takes (None: any), and those it
    # refuses; AssertionError otherwise, as in the JAX package
    SUPPORTED_BASES = None
    UNSUPPORTED_BASES = ()
    # the wrapper reads the base's ``fwd`` (ReMixMatch then runs its
    # labeled forward, as the JAX loss does)
    READS_FWD = False

    def __init__(self, cfg, data_info=None, device=None, base_cls=None):
        super().__init__(cfg, data_info, device)
        if base_cls is None:
            raise AssertionError("imb algorithms wrap a base algorithm")
        if (self.SUPPORTED_BASES is not None
                and cfg.algorithm not in self.SUPPORTED_BASES):
            raise AssertionError(
                f"{self.NAME} only supports {self.SUPPORTED_BASES} as base")
        if cfg.algorithm in self.UNSUPPORTED_BASES:
            raise AssertionError(
                f"{self.NAME} does not support {cfg.algorithm} as base")
        if getattr(base_cls, "HAS_SR", False):
            raise NotImplementedError(
                f"{self.NAME} over the SemiReward variant {cfg.algorithm}: "
                f"the JAX package's step skips the rewarder's training under "
                f"an imb wrapper and its loss fails on the missing "
                f"SemiReward state")
        self.base = base_cls(cfg, data_info, device)
        if self.READS_FWD and hasattr(self.base, "keep_fwd"):
            self.base.keep_fwd = True
        self.BATCH_KEYS = tuple(self.base.BATCH_KEYS)
        self.WEAK_ULB_S = getattr(self.base, "WEAK_ULB_S", False)
        self._imb_state = None
        self._cell: Dict[str, Any] = {}

    def set_rho_init(self, algo_state, rho_init: float):
        base_state, imb_state = algo_state
        return self.base.set_rho_init(base_state, rho_init), imb_state

    # ---- labeled class distribution ---------------------------------------
    def lb_class_counts(self) -> np.ndarray:
        dist = self.data_info.get("lb_class_dist")
        if dist is None:
            return np.ones(self.cfg.num_classes)
        n = self.data_info.get("lb_dest_len", self.cfg.num_classes)
        return np.asarray(dist) * n

    def _const(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # ---- composition -------------------------------------------------------
    def wrap_model(self, model, generator=None):
        return self.base.wrap_model(model, generator)

    def init_state(self):
        return (self.base.init_state(), self.init_imb_state())

    def init_imb_state(self):
        return ()

    def override_names(self):
        return ()

    @contextlib.contextmanager
    def installed(self):
        """The ``override_names`` hooks of the base swapped for this
        wrapper's ``imb_<name>``, restored on exit."""
        names = self.override_names()
        for name in names:
            setattr(self.base, name, getattr(self, f"imb_{name}"))
        try:
            yield
        finally:
            for name in names:
                self.base.__dict__.pop(name, None)

    def base_loss(self, ctx: StepCtx, imb_state) -> LossOut:
        """The base's loss on ``base_state`` with the hooks installed; the
        hooks see ``imb_state`` and the per-step cell."""
        base_state = ctx.algo_state[0]
        self._imb_state = imb_state
        with self.installed():
            return self.base.loss(ctx._replace(algo_state=base_state))

    def loss(self, ctx: StepCtx) -> LossOut:
        imb_state = ctx.algo_state[1]
        self._cell = self.pre_loss(ctx)
        out = self.base_loss(ctx, imb_state)
        out = self.post_loss(out, imb_state, ctx)
        new_imb = self.update_imb_state(imb_state, out, ctx)
        return out._replace(new_algo_state=(out.new_algo_state, new_imb))

    # ---- extension points --------------------------------------------------
    def pre_loss(self, ctx: StepCtx) -> Dict[str, Any]:
        """Work before the base's forward (which moves the BatchNorm
        running statistics in place); returns the step's first cell."""
        return {}

    def post_loss(self, out: LossOut, imb_state, ctx: StepCtx) -> LossOut:
        return out

    def update_imb_state(self, imb_state, out: LossOut, ctx: StepCtx):
        return imb_state

    def on_epoch_end(self, trainer, state):
        """The host's work at an epoch boundary; returns the state."""
        return state

    def iters_per_epoch(self) -> int:
        return max(self.cfg.num_train_iter // max(self.cfg.epoch, 1), 1)

    def epoch_of(self, step: int) -> int:
        return step // self.iters_per_epoch()

    def _add_loss(self, out: LossOut, term, name: str, value) -> LossOut:
        total = out.total_loss + term
        metrics = dict(out.metrics)
        metrics["total_loss"] = total
        metrics[name] = value
        return out._replace(total_loss=total, metrics=metrics)


def refuse_lazy_images(ds, what: str) -> None:
    """Raise ``NotImplementedError`` where ``what`` needs a dataset's whole
    image array and ``ds`` decodes a batch at a time (a JPEG folder): the
    JAX package reads ``.data`` there and fails with ``AttributeError``
    (ROADMAP section 3)."""
    if not hasattr(ds, "data"):
        raise NotImplementedError(
            f"{what} reads the whole image array of its data, which a JPEG "
            f"folder dataset ({type(ds).__name__}) does not hold; the JAX "
            f"package fails there too (ROADMAP section 3)")


def predict_ulb_logits(trainer) -> np.ndarray:
    """Logits of the EMA weights over the whole unlabeled set, eval
    transforms (normalize only), the main head: the reference's
    ``eval_ulb`` loader."""
    from semireward_tpu_torch.data.loader import eval_batches

    names = [n for n, _ in trainer.model.named_parameters()]
    weights = dict(zip(names, trainer.state.ema))
    outs = []
    for b in eval_batches(trainer.bundle.train_ulb, trainer.cfg.eval_batch_size):
        outs.append(trainer._logits(b["x"], weights)[b["mask"]])
    return np.concatenate(outs)


def softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)
