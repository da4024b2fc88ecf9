"""Training loop (port of the CV, NLP and audio branches of
``semireward_tpu/core/trainer.py``): build data, model, algorithm and state
from a ``Config``, run the step loop with the log and eval cadence, and
evaluate / predict with the EMA weights. The CV branch takes the ViTs
(usb_cv) and the WideResNets (classic_cv: BatchNorm running statistics
are model buffers that the train step updates in place; the EMA covers
parameters only, and eval runs the EMA parameters with the live running
statistics, BatchNorm in eval mode).

Per step, CV: the host gathers a raw uint8 batch (seeded samplers), copies
it to the device, builds the weak/strong views there. NLP: the host
tokenizes the views into one static length bucket and copies the token
dicts over. Audio: the host crops / pads the waveforms into the fixed
bucket, the strong views' crops go over raw and get their sox effects on
the device. Then the train step runs. Metrics stay on the device until a log
boundary. Not ported yet (ROADMAP): checkpoint save/resume, the metrics
sink, prefetch, pretrained grafting, bio data.
"""
from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from semireward_tpu_torch import resolve_device
from semireward_tpu_torch import algorithms as _algorithms  # noqa: F401
from semireward_tpu_torch import models as _models  # noqa: F401
from semireward_tpu_torch.config import Config
from semireward_tpu_torch.core import metrics as M
from semireward_tpu_torch.core.optim import cosine_schedule_with_warmup
from semireward_tpu_torch.core.step import init_train_state, make_train_step
from semireward_tpu_torch.data.augment import (AugmentSpec, augment_views,
                                               normalize)
from semireward_tpu_torch.data.datasets import SSLDataBundle, get_dataset
from semireward_tpu_torch.data.loader import SSLLoader, eval_batches
from semireward_tpu_torch.data.modality import (AudioSSLLoader,
                                                GenericBundle, NLPSSLLoader,
                                                modality_of)
from semireward_tpu_torch.registry import ALGORITHMS, NETS

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
# nets whose MLP runs the fused kernels unless the config says otherwise, as
# in the JAX package (K1 at ViT-S widths, K3 at C = 768)
FUSED_MLP_NETS = ("vit_", "bert_", "hubert_", "wave2vecv2_")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


def flash_auto_default(cfg: Config, device: torch.device) -> bool:
    """``use_flash_attention`` when the config leaves it unset, set by the
    H100 A/Bs of ``python -m semireward_tpu_torch.ab_flash`` (PERF.md): on a
    CUDA card, on for the ViTs (ViT-S/2-32, N = 257: a fifth less device
    time per step, 0.98-1.12x the steps/s of the unfused attention), for
    BERT at ``max_length`` >= 384 (BERT-base at 512: 1.10-1.72x) and for
    HuBERT / wav2vec2 (HuBERT-base at N = 199: 1.08x, every flash window
    faster than every unfused one). Shorter BERT runs are not measured yet
    and stay off, as in the JAX package. The CPU runs the plain version
    either way."""
    return device.type == "cuda" and (
        cfg.net.startswith(("vit_", "hubert_", "wave2vecv2_"))
        or (cfg.net.startswith("bert_") and cfg.max_length >= 384))


class Trainer:
    """``Trainer(cfg).train()`` is the CLI path; ``evaluate``/``predict``
    score the EMA weights. Runs on CUDA unless ``device='cpu'``."""

    def __init__(self, cfg: Config, bundle: Optional[SSLDataBundle] = None,
                 device=None, logger: Optional[logging.Logger] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger(
            f"semireward_tpu_torch.{cfg.save_name}")
        if cfg.resume and cfg.load_path and os.path.exists(
                cfg.load_path.replace(".pth", ".ckpt")):
            _not_ported("resume from a checkpoint", "checkpoint/resume")
        if cfg.use_pretrain:
            _not_ported("grafting released pretrained weights",
                        "pretrained weights")
        if cfg.imb_algorithm:
            _not_ported("imbalanced SSL", "imb")
        if cfg.gradient_checkpointing:
            _not_ported("gradient checkpointing", "remat")
        self.modality = modality_of(cfg.net)
        if self.modality == "audio" and not cfg.extra.get("audio_exact_reverb",
                                                          True):
            _not_ported("the fast reverb (audio_exact_reverb False)", "audio")
        if cfg.net.startswith("dnabert"):
            _not_ported("bio/DNA data", "NLP and bio")

        if self.modality == "nlp":
            from semireward_tpu_torch.data.nlp import (NLPCollator,
                                                       auto_buckets,
                                                       get_nlp_dataset,
                                                       get_tokenizer)
            self.bundle = bundle if bundle is not None else GenericBundle(
                get_nlp_dataset(cfg, cfg.algorithm), cfg.num_classes)
            # static length buckets (default 64/128/256/max_length):
            # extra['length_buckets'] = a list to override, False/[] to
            # pin the single max_length bucket
            bk = cfg.extra.get("length_buckets", "auto")
            bk = auto_buckets(cfg.max_length) if bk == "auto" else (bk or None)
            self.collator = NLPCollator(get_tokenizer(cfg.net),
                                        max_length=cfg.max_length, buckets=bk)
        elif self.modality == "audio":
            from semireward_tpu_torch.data.audio import (AudioCollator,
                                                         get_audio_dataset)
            self.bundle = bundle if bundle is not None else GenericBundle(
                get_audio_dataset(cfg, cfg.algorithm), cfg.num_classes)
            self.collator = AudioCollator(cfg.max_length_seconds,
                                          cfg.sample_rate)
        else:
            self.bundle = bundle if bundle is not None else get_dataset(
                cfg, cfg.algorithm)
        data_info = {"ulb_dest_len": self.bundle.ulb_dest_len,
                     "lb_dest_len": self.bundle.lb_dest_len}

        builder = NETS.get(cfg.net)
        fused = cfg.extra.get("use_fused_mlp")
        flash = cfg.extra.get("use_flash_attention")
        net_kw = {"use_fused_mlp": (cfg.net.startswith(FUSED_MLP_NETS)
                                    if fused is None else bool(fused)),
                  "use_flash": (flash_auto_default(cfg, self.device)
                                if flash is None else bool(flash))}
        # explicit geometry overrides for the builder (small runs); a JSON
        # object when it comes from the command line
        extra_kw = cfg.extra.get("net_kwargs", {})
        net_kw.update(json.loads(extra_kw) if isinstance(extra_kw, str)
                      else extra_kw)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.model = builder(num_classes=cfg.num_classes,
                             dtype=_DTYPES[cfg.compute_dtype],
                             device=self.device, generator=self.generator,
                             img_size=cfg.img_size, **net_kw)
        # the rewarder reads the net's features: its input width is the
        # net's (the classic_cv YAMLs say 384, WRN-28-2's features are 128)
        width = getattr(self.model, "num_features", cfg.feature_dim)
        if width != cfg.feature_dim:
            self.logger.info(f"feature_dim {cfg.feature_dim} -> {width}, the "
                             f"width of {cfg.net}'s features")
            cfg.feature_dim = width
        self.alg = ALGORITHMS.get(cfg.algorithm)(cfg, data_info, self.device)
        no_color = bool(cfg.extra.get(
            "randaug_no_color", cfg.dataset in ("tissuemnist", "medmnist")))
        self.aug_spec = AugmentSpec(
            crop_size=cfg.img_size,
            crop_pad=int(cfg.img_size * (1 - cfg.crop_ratio)),
            mean=self.bundle.mean, std=self.bundle.std, randaug_n=3,
            exclude_color=no_color) if self.modality == "cv" else None
        self.state = init_train_state(cfg, self.alg, self.model, builder,
                                      self.generator)
        self._step = make_train_step(cfg, self.alg)
        self._schedule = cosine_schedule_with_warmup(
            cfg.lr, cfg.num_train_iter, cfg.num_warmup_iter)
        self.best_metric = -math.inf
        self.best_it = 0
        self.log_history = []  # one dict per log boundary

    # ------------------------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _make_loader(self):
        cfg = self.cfg
        if self.modality in ("nlp", "audio"):
            loader = NLPSSLLoader if self.modality == "nlp" else AudioSSLLoader
            return loader(
                {"train_lb": self.bundle.train_lb,
                 "train_ulb": self.bundle.train_ulb},
                self.collator, cfg.batch_size, cfg.ulb_batch_size,
                self.alg.BATCH_KEYS, seed=cfg.seed)
        return SSLLoader(self.bundle, cfg.batch_size, cfg.ulb_batch_size,
                         seed=cfg.seed, sampler=cfg.train_sampler)

    def make_batch(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Raw host batch -> device views + labels/indices the algorithm
        consumes. Token views go over as they are (no augmentation);
        waveform crops under ``<view>_base`` become that strong view on the
        device, with draws from the trainer's generator."""
        if self.modality == "nlp":
            batch = {k: {kk: self._to_device(vv) for kk, vv in v.items()}
                     for k, v in raw.items() if k.startswith("x_")}
        elif self.modality == "audio":
            from semireward_tpu_torch.data.audio import (apply_strong_wave,
                                                         draw_strong_wave)
            batch = {}
            for k, v in raw.items():
                if k.endswith("_base"):
                    x = self._to_device(v)
                    batch[k[:-5]] = apply_strong_wave(
                        x, draw_strong_wave(self.generator, x.shape[0],
                                            self.device))
                elif k.startswith("x_"):
                    batch[k] = self._to_device(v)
        else:
            batch = augment_views(
                self._to_device(raw["x_lb"]), self._to_device(raw["x_ulb"]),
                self.aug_spec,
                [k for k in self.alg.BATCH_KEYS if k.startswith("x_")],
                self.generator,
                weak_ulb_s=getattr(self.alg, "WEAK_ULB_S", False))
        for k in ("y_lb", "idx_lb", "idx_ulb"):
            if k in raw:
                batch[k] = self._to_device(raw[k].astype(np.int64))
        return batch

    def train(self, num_iters: Optional[int] = None,
              eval_hook: Optional[Callable] = None,
              step_hook: Optional[Callable] = None) -> Dict[str, float]:
        """Run steps ``state.step .. num_iters``. ``step_hook(step, metrics)``
        sees each step's device metrics (no host sync)."""
        cfg = self.cfg
        num_iters = num_iters or cfg.num_train_iter
        loader = self._make_loader()
        for _ in range(self.state.step):  # keep the index stream aligned
            next(loader)
        log = self.logger.info
        results: Dict[str, float] = {}
        t0 = time.time()
        window_start = self.state.step
        for it in range(self.state.step, num_iters):
            metrics = self._step(self.state, self.make_batch(next(loader)),
                                 self.generator)
            step_now = it + 1
            if step_hook is not None:
                step_hook(step_now, metrics)
            if step_now % cfg.num_log_iter == 0:
                fetched = {k: float(v) for k, v in metrics.items()
                           if v.ndim == 0}
                fetched = {k: v for k, v in fetched.items()
                           if math.isfinite(v) or math.isnan(v)}
                dt = time.time() - t0
                n = step_now - window_start
                sps = n / dt if n else 0.0
                lr = self._schedule(step_now)
                log(f"it {step_now}/{num_iters} "
                    + " ".join(f"{k}={v:.4f}" for k, v in sorted(fetched.items()))
                    + f" lr={lr:.2e} steps/s={sps:.2f}")
                self.log_history.append({"step": step_now, "steps": n,
                                         "seconds": dt, **fetched})
                t0, window_start = time.time(), step_now
            if step_now % cfg.num_eval_iter == 0 or step_now == num_iters:
                eval_m = self.evaluate()
                key = "top-1-acc" if not cfg.is_regression else "mse"
                score = eval_m[key] if not cfg.is_regression else -eval_m[key]
                if score > self.best_metric:
                    self.best_metric, self.best_it = score, step_now
                log(f"eval @ {step_now}: "
                    + " ".join(f"{k}={v:.4f}" for k, v in eval_m.items())
                    + f" (best {self.best_metric:.4f} @ {self.best_it})")
                results = {f"eval/{k}": v for k, v in eval_m.items()}
                results["eval/best_acc"] = self.best_metric
                results["eval/best_it"] = self.best_it
                if eval_hook:
                    eval_hook(step_now, eval_m)
                t0, window_start = time.time(), step_now
        return results

    @torch.no_grad()
    def _logits(self, x) -> np.ndarray:
        """Logits of the EMA weights for an image batch, a token dict or a
        waveform batch (no normalization for tokens and waveforms)."""
        names = [n for n, _ in self.model.named_parameters()]
        weights = dict(zip(names, self.state.ema))
        if isinstance(x, dict):
            xs = {k: self._to_device(v) for k, v in x.items()}
        elif self.modality == "audio":
            xs = self._to_device(x)
        else:
            xs = normalize(self._to_device(x), self.aug_spec.mean,
                           self.aug_spec.std)
        out = functional_call(self.model, weights, (xs,), {"train": False})
        return out["logits"].float().cpu().numpy()

    def _eval_batches(self, ds):
        """Fixed-shape eval batches with a validity mask; NLP texts are
        tokenized into one bucket per batch, waveforms cropped / padded to
        the bucket."""
        bs = self.cfg.eval_batch_size
        if self.modality == "cv":
            yield from eval_batches(ds, bs)
            return
        n = len(ds)
        for start in range(0, n, bs):
            stop = min(start + bs, n)
            idx = np.arange(start, stop)
            pad = bs - len(idx)
            mask = np.ones(bs, bool)
            if pad:
                idx = np.concatenate([idx, np.full(pad, stop - 1)])
                mask[bs - pad:] = False
            items = ds.texts if self.modality == "nlp" else ds.waves
            yield {"x": self.collator([items[i] for i in idx]),
                   "y": np.asarray(ds.targets)[idx], "mask": mask}

    def evaluate(self) -> Dict[str, float]:
        """Metrics of the EMA weights on the eval split."""
        preds, trues, logits_all = [], [], []
        for b in self._eval_batches(self.bundle.eval):
            logits = self._logits(b["x"])[b["mask"]]
            preds.append(logits.argmax(-1))
            trues.append(b["y"][b["mask"]])
            logits_all.append(logits)
        y_pred, y_true = np.concatenate(preds), np.concatenate(trues)
        y_logits = np.concatenate(logits_all)
        if self.cfg.is_regression:
            return M.regression_metrics(y_true, y_logits[:, 0])
        out = M.classification_metrics(y_true, y_pred, self.cfg.num_classes,
                                       y_logits)
        lp = y_logits - y_logits.max(-1, keepdims=True)
        lse = np.log(np.exp(lp).sum(-1))
        out["loss"] = float((lse - lp[np.arange(len(y_true)), y_true]).mean())
        return out

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Logits for images ``[n, H, W, 3]`` or, for NLP and audio nets, a
        list of texts or waveforms."""
        bs = batch_size or self.cfg.eval_batch_size
        if self.modality in ("nlp", "audio"):
            return np.concatenate([self._logits(self.collator(x[s:s + bs]))
                                   for s in range(0, len(x), bs)])
        return np.concatenate([self._logits(x[s:s + bs])
                               for s in range(0, len(x), bs)])
