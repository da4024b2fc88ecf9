"""CReST / CReST+ (port of ``semireward_tpu/imb/crest.py``): generational
self-training. Each generation retrains from scratch on the labeled set
grown by the previous generation's most confident pseudo-labeled samples,
tail classes taking more (``crest_split``). With ``crest_pro_dist_align``
(CReST+) the wrapper swaps in a progressive distribution alignment whose
target temperature anneals from 1 to ``crest_dist_align_t`` across the
generations (``maybe_dist_align``; ReMixMatch never calls that hook).

``train_crest`` is the generational driver, a library function as in the
JAX package: a ``crest`` YAML through the CLI trains generation 0 alone,
through the plain composition."""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional

import numpy as np
import torch

from semireward_tpu_torch.algorithms import common as C
from semireward_tpu_torch.imb.base import (ImbAlgorithm, predict_ulb_logits,
                                           refuse_lazy_images, softmax_np)
from semireward_tpu_torch.registry import IMB_ALGORITHMS


@IMB_ALGORITHMS.register("crest")
@IMB_ALGORITHMS.register("crest+")
class CReST(ImbAlgorithm):
    NAME = "crest"
    DEFAULTS = {"crest_num_gens": 6, "crest_dist_align_t": 0.5,
                "crest_pro_dist_align": True, "crest_alpha": 3}

    def __init__(self, cfg, data_info=None, device=None, base_cls=None,
                 gen: int = 0):
        super().__init__(cfg, data_info, device, base_cls)
        x = cfg.extra
        self.num_gens = int(x.get("crest_num_gens", 6))
        self.dist_align_t = float(x.get("crest_dist_align_t", 0.5))
        self.pro_dist_align = bool(x.get("crest_pro_dist_align", True))
        self.sampling_alpha = float(x.get("crest_alpha", 3))
        self.gen = gen
        if self.num_gens > 1 and self.pro_dist_align:
            cur = gen / (self.num_gens - 1)
            self.cur_dist_align_t = (1.0 - cur) * 1.0 + cur * self.dist_align_t
        else:
            self.cur_dist_align_t = self.dist_align_t

    def init_imb_state(self):
        if not self.pro_dist_align:
            return ()
        n = self.cfg.num_classes
        dist = self.data_info.get("lb_class_dist", np.full(n, 1 / n))
        return C.dist_align_ema_init(n, p_target=self._const(dist),
                                     device=self.device)[0]

    def override_names(self):
        return ("maybe_dist_align",) if self.pro_dist_align else ()

    def imb_maybe_dist_align(self, probs_x_ulb, probs_x_lb=None):
        st = self._cell.get("da_state", self._imb_state)
        m = 0.999
        mean_ulb = probs_x_ulb.mean(0)
        p_model = torch.where(st.initialized,
                              st.p_model * m + mean_ulb * (1 - m), mean_ulb)
        self._cell["da_state"] = replace(
            st, p_model=p_model.detach(),
            initialized=torch.ones_like(st.initialized))
        p_target = st.p_target
        if self.cur_dist_align_t != 1:
            p_target = p_target ** self.cur_dist_align_t
            p_target = p_target / p_target.sum()
        aligned = probs_x_ulb * (p_target + 1e-6) / (p_model + 1e-6)
        return aligned / aligned.sum(-1, keepdim=True)

    def update_imb_state(self, imb_state, out, ctx):
        return self._cell.get("da_state", imb_state)


def crest_split(lb_data, lb_targets, ulb_data, ulb_targets, lb_class_dist,
                pseudo_label_list: Optional[List[np.ndarray]],
                sampling_alpha: float, num_classes: int):
    """The labeled set of the next generation: per class (largest labeled
    share first) the first ``len * mu^((C - 1 - c) / alpha)`` of its
    pseudo-labeled samples, then the labeled set; numpy, as the JAX
    package's."""
    if not pseudo_label_list:
        return lb_data, lb_targets
    data_picked, targets_picked = [], []
    sorted_class = np.argsort(lb_class_dist)[::-1]
    imb = lb_class_dist[sorted_class][0] / lb_class_dist[sorted_class[-1]]
    mu = np.power(1.0 / imb, 1 / (num_classes - 1))
    for c in sorted_class:
        num_picked = int(len(pseudo_label_list[c])
                         * np.power(np.power(mu, (num_classes - 1) - c),
                                    1 / sampling_alpha))
        idx = np.asarray(pseudo_label_list[c][:num_picked], np.int64)
        if len(idx) > 0:
            data_picked.append(ulb_data[idx])
            targets_picked.append(np.full(len(idx), c,
                                          dtype=np.asarray(lb_targets).dtype))
    data_picked.append(lb_data)
    targets_picked.append(lb_targets)
    return np.concatenate(data_picked, 0), np.concatenate(targets_picked, 0)


def pseudo_label_lists(logits: np.ndarray, num_classes: int):
    """Per class, the unlabeled indices predicted as that class, most
    confident first."""
    probs = softmax_np(logits)
    score, pred = probs.max(-1), probs.argmax(-1)
    out = []
    for c in range(num_classes):
        idx = np.where(pred == c)[0]
        out.append(idx[np.argsort(score[idx])[::-1]])
    return out


def train_crest(cfg, logger=None, device=None, num_iters=None,
                on_generation=None):
    """The generational driver: ``crest_num_gens`` trainers, each from
    scratch on ``crest_split`` of the first generation's labeled set and
    the last one's pseudo-labels (a full unlabeled forward of its EMA
    weights). ``on_generation(gen, trainer)`` sees each trained
    generation. Returns ``({gen_<i>: results}, last trainer)``."""
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.data.datasets import (ArrayDataset,
                                                    SSLDataBundle,
                                                    get_dataset)
    from semireward_tpu_torch.registry import ALGORITHMS

    base_cfg = cfg.replace(include_lb_to_ulb=False)
    bundle0 = get_dataset(base_cfg, cfg.algorithm, device=device)
    for ds in (bundle0.train_lb, bundle0.train_ulb):
        refuse_lazy_images(ds, "CReST's generation loop (train_crest)")
    lb_data0, lb_tgt0 = bundle0.train_lb.data, bundle0.train_lb.targets
    counts = np.bincount(np.asarray(lb_tgt0, np.int64),
                         minlength=cfg.num_classes).astype(np.float64)
    lb_class_dist = counts / counts.sum()
    num_gens = int(cfg.extra.get("crest_num_gens", 6))
    alpha = float(cfg.extra.get("crest_alpha", 3))
    pseudo_label_list, best, trainer = None, {}, None
    for gen in range(num_gens):
        lb_data, lb_tgt = crest_split(
            lb_data0, lb_tgt0, bundle0.train_ulb.data,
            bundle0.train_ulb.targets, lb_class_dist, pseudo_label_list,
            alpha, cfg.num_classes)
        bundle = SSLDataBundle(
            train_lb=ArrayDataset(lb_data, lb_tgt),
            train_ulb=bundle0.train_ulb, eval=bundle0.eval,
            num_classes=bundle0.num_classes, mean=bundle0.mean,
            std=bundle0.std)

        def factory(c, data_info, dev, _gen=gen):
            return CReST(c, data_info, dev,
                         base_cls=ALGORITHMS.get(cfg.algorithm), gen=_gen)

        trainer = Trainer(base_cfg.replace(), bundle=bundle, device=device,
                          logger=logger, alg_factory=factory)
        best[f"gen_{gen}"] = trainer.train(num_iters=num_iters)
        if on_generation is not None:
            on_generation(gen, trainer)
        pseudo_label_list = pseudo_label_lists(predict_ulb_logits(trainer),
                                               cfg.num_classes)
    return best, trainer
