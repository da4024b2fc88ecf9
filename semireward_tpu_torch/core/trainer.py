"""Training loop (port of the CV, NLP and audio branches of
``semireward_tpu/core/trainer.py``): build data, model, algorithm and state
from a ``Config``, run the step loop with the log and eval cadence, and
evaluate / predict with the EMA weights. The CV branch takes the ViTs
(usb_cv) and the WideResNets (classic_cv: BatchNorm running statistics
are model buffers that the train step updates in place; the EMA covers
parameters only, and eval runs the EMA parameters with the live running
statistics, BatchNorm in eval mode).

Per step, CV: the host gathers a raw uint8 batch (seeded samplers), copies
it to the device, builds the weak/strong views there; a full-size JPEG set
decodes its batch on the card (nvJPEG) at ``img_size / crop_ratio``, the
views crop it (``AugmentSpec.src_size``) and the eval center-crops it.
NLP: the host tokenizes the views into one static length bucket and copies
the token dicts over (a ``dnabert*`` net reads CSV k-mer data,
``data/bio.py``, each view padded to ``max_length``). Audio: the host crops /
pads the waveforms into the fixed bucket, the strong views' crops go over
raw and get their sox effects on the device (the exact reverb, or with
``extra['audio_exact_reverb']`` False the fast one). Then the train step runs. Metrics stay on the device until a log
boundary. With ``extra['prefetch_depth']`` > 0 a producer thread
assembles the host batches ahead of the step (``PrefetchLoader``); the
device copies and augmentation stay on the main thread.

At each eval boundary the trainer writes ``latest_model.ckpt`` and, when
the metric improved, ``model_best.ckpt`` under ``save_dir/save_name``
(``core/checkpoint.py``) and logs to ``metrics.jsonl`` there
(``utils/metrics_sink.py``); after the run it scores the test split, where
the data has one, with the best checkpoint's weights. ``load`` resumes a
run; ``use_pretrain`` grafts released weights onto the net before the EMA
and the optimizer are built. An algorithm may put the net under a wrapper
with heads of its own (ReMixMatch, CRMatch, CoMatch, SimMatch) before the
state is built, and
Dash trains a supervised warm-up (``warmup``) before its first step, also
under a wrapper (SemiReward or imbalanced SSL: the trainer reads the
base's ``NEEDS_WARMUP``). With ``imb_algorithm`` the algorithm is that
wrapper over ``algorithm`` (``imb/``; ``alg_factory`` builds any other),
and the trainer runs its hooks: ``on_epoch_end(trainer, state)`` at every
epoch boundary (``step % (num_train_iter // epoch) == 0``), the eval head
``eval_out_key(step)`` / ``EVAL_OUT_KEY``, and the step's
``post_param_update``. A form of an algorithm that the port does not run
raises before any data is loaded (``refuse_unported``).

The mesh (``parallel/mesh.py``), as the JAX trainer: the process joins a
group under torchrun (``WORLD_SIZE`` > 1) or with ``extra['multihost']``,
on the card ``cuda:LOCAL_RANK``; the YAML's ``mesh_shape`` /
``mesh_axes`` are resolved against the ranks and fail as JAX's
``build_mesh`` where they do not fit (on one rank too). With a group the
mesh is active: the nets get it as ``fused_mesh`` where a kernel is on or
the mesh has a ``model`` axis (the K4 forms, tensor parallelism), the
state takes its layout, each rank's loader draws its rank-strided share of
the batch (the batch sizes divided by the batch shards), every rank
evaluates the whole eval set (the same metrics as one process), every rank
calls the checkpoint writes and rank 0 writes, and the best checkpoint is
read back after the run only if every rank sees it (JAX's multi-host
rule).
"""
from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from semireward_tpu_torch import resolve_device
from semireward_tpu_torch import algorithms as _algorithms  # noqa: F401
from semireward_tpu_torch import models as _models  # noqa: F401
from semireward_tpu_torch.algorithms.base import SupervisedWarmup
from semireward_tpu_torch.config import Config
from semireward_tpu_torch.core import checkpoint as ckpt
from semireward_tpu_torch.core import metrics as M
from semireward_tpu_torch.core.optim import cosine_schedule_with_warmup
from semireward_tpu_torch.core.step import init_train_state, make_train_step
from semireward_tpu_torch.data.augment import (AugmentSpec, augment_views,
                                               normalize)
from semireward_tpu_torch.data.datasets import SSLDataBundle, get_dataset
from semireward_tpu_torch.data.loader import (PrefetchLoader, SSLLoader,
                                              eval_batches)
from semireward_tpu_torch.data.modality import (AudioSSLLoader,
                                                GenericBundle, NLPSSLLoader,
                                                modality_of)
from semireward_tpu_torch.parallel import mesh as mesh_lib
from semireward_tpu_torch.registry import ALGORITHMS, IMB_ALGORITHMS, NETS

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
# the BERT-geometry text nets: BERT, DNABERT-2 and the generic HF text
# classifier (the flax builders of the last two take no kernel switch)
BERT_NETS = ("bert_", "dnabert_", "hf_text_")
# the ViT family: the ViTs and DINOv2 on them
VIT_NETS = ("vit_", "dinov2_")
# nets whose MLP runs the fused kernels unless the config says otherwise, as
# in the JAX package (K1 at ViT-S widths, K3 at C 768 and DINOv2 ViT-L/14's
# 1024), and the BERT geometry's other text nets
FUSED_MLP_NETS = VIT_NETS + ("hubert_", "wave2vecv2_") + BERT_NETS


# No producer thread unless the config asks for one: set by the H100 A/B
# of ``python -m semireward_tpu_torch.ab_flash --knob prefetch_depth``
# (PERF.md), where depth 2 against 0 ran 0.92-1.01x on the headline ViT-S
# step and 0.90-1.01x on the BERT-base step (the host-bound steps lose the
# GIL to the producer; the host batch work it takes over is small). The
# JAX package's default of 2 was set on a TPU host.
PREFETCH_DEPTH_DEFAULT = 0


class _NoSink:
    """The metrics sink of a rank other than 0 (rank 0 writes the files)."""

    def log(self, *a, **kw):
        pass

    def close(self):
        pass


def refuse_unported(cfg: Config) -> None:
    """Raise, before any data is loaded, for a form of the algorithm that
    the port does not run (``Algorithm.check_ported``: not ported yet, or
    one the JAX package fails on) and for an imbalanced-SSL wrapper that is
    not registered."""
    ALGORITHMS.get(cfg.algorithm).check_ported(cfg)
    if cfg.imb_algorithm:
        from semireward_tpu_torch import imb as _imb  # noqa: F401
        IMB_ALGORITHMS.get(cfg.imb_algorithm)


def flash_auto_default(cfg: Config, device: torch.device) -> bool:
    """``use_flash_attention`` when the config leaves it unset, set by the
    H100 A/Bs of ``python -m semireward_tpu_torch.ab_flash`` (PERF.md): on a
    CUDA card, on for the ViTs (ViT-S/2-32, N = 257: a fifth less device
    time per step, 0.98-1.12x the steps/s of the unfused attention), for
    BERT at ``max_length`` >= 384 (BERT-base at 512: 1.10-1.72x) and for
    HuBERT / wav2vec2 (HuBERT-base at N = 199: 1.08x, every flash window
    faster than every unfused one); DNABERT-2 and the HF text classifier,
    BERT's geometry, as BERT. DINOv2 follows the ViT rule unmeasured.
    Shorter BERT runs are not measured yet and stay off, as in the JAX
    package. The CPU runs the plain version either way."""
    return device.type == "cuda" and (
        cfg.net.startswith(VIT_NETS + ("hubert_", "wave2vecv2_"))
        or (cfg.net.startswith(BERT_NETS) and cfg.max_length >= 384))


class Trainer:
    """``Trainer(cfg).train()`` is the CLI path; ``evaluate``/``predict``
    score the EMA weights (the live ones with ``eval_use_ema = False``).
    Runs on CUDA unless ``device='cpu'``. The run's generator (init,
    augmentation, dropout) lives on ``rng_device``, by default the training
    device; ``rng_device='cpu'`` gives a run on the card the draws of the
    same run on the CPU (``semireward_tpu_torch/rng.py``)."""

    def __init__(self, cfg: Config, bundle: Optional[SSLDataBundle] = None,
                 device=None, logger: Optional[logging.Logger] = None,
                 alg_factory: Optional[Callable] = None, rng_device=None):
        self.cfg = cfg
        self.rank, self.world = mesh_lib.setup_distributed(cfg, device)
        joined = torch.distributed.is_initialized()
        if device is None and joined and torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local)
            device = torch.device("cuda", local)
        self.device = resolve_device(device)
        rng_device = resolve_device(rng_device or self.device)
        self.logger = logger or logging.getLogger(
            f"semireward_tpu_torch.{cfg.save_name}")
        # the YAML's mesh, resolved against the ranks: one it does not fit
        # fails as the JAX package's build_mesh does
        mesh = mesh_lib.build_mesh(cfg.mesh_shape, cfg.mesh_axes, self.world,
                                   self.rank)
        self.mesh = mesh if joined else None
        mesh_lib.activate(self.mesh)
        refuse_unported(cfg)
        self.modality = modality_of(cfg.net)

        if self.modality == "nlp" and cfg.net.startswith("dnabert"):
            # CSV k-mer data on the NLP pipeline with its own collator
            from semireward_tpu_torch.data.bio import (BioCollator,
                                                       get_bio_dataset)
            self.bundle = bundle if bundle is not None else GenericBundle(
                get_bio_dataset(cfg, cfg.algorithm), cfg.num_classes)
            self.collator = BioCollator(k=int(cfg.extra.get("kmer", 6)),
                                        max_length=cfg.max_length)
        elif self.modality == "nlp":
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
                cfg, cfg.algorithm, device=self.device)
        data_info = {"ulb_dest_len": self.bundle.ulb_dest_len,
                     "lb_dest_len": self.bundle.lb_dest_len}
        if not cfg.is_regression:
            counts = np.bincount(
                np.asarray(self.bundle.train_lb.targets, np.int64),
                minlength=cfg.num_classes).astype(np.float64)
            data_info["lb_class_dist"] = counts / max(counts.sum(), 1)

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
        # as the JAX trainer: the BatchNorm momentum override (the
        # WideResNets read it) and gradient checkpointing (each ViT block
        # recomputed in the backward; the other builders ignore it)
        if "bn_momentum" in cfg.extra:
            net_kw["bn_momentum"] = float(cfg.extra["bn_momentum"])
        if cfg.gradient_checkpointing:
            net_kw["remat"] = True
        if self.mesh is not None and (
                net_kw["use_fused_mlp"] or net_kw["use_flash"]
                or "model" in self.mesh.axis_names):
            # the K4 forms, and tensor parallelism in the nets
            net_kw["fused_mesh"] = self.mesh
        self.generator = torch.Generator(device=rng_device).manual_seed(
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
        data_info["num_features"] = width
        if alg_factory is not None:
            self.alg = alg_factory(cfg, data_info, self.device)
        elif cfg.imb_algorithm:
            from semireward_tpu_torch.imb import get_imb_algorithm
            self.alg = get_imb_algorithm(cfg.imb_algorithm)(
                cfg, data_info, self.device,
                base_cls=ALGORITHMS.get(cfg.algorithm))
        else:
            self.alg = ALGORITHMS.get(cfg.algorithm)(cfg, data_info,
                                                     self.device)
        # heads of the algorithm's own (ReMixMatch, CRMatch, CoMatch,
        # SimMatch, ABC / TRAS, CoSSL) go on before the state is built,
        # the backbone under ``backbone``
        self.model = self.alg.wrap_model(self.model, self.generator)
        if cfg.use_pretrain:
            # the released weights replace the init before the EMA shadow
            # is taken (it restarts from them) and the optimizer moments
            # are made (zero); each parameter keeps its init dtype. The
            # graft names the bare net's parameters, so on a wrapped net it
            # raises a KeyError, as the JAX package's does
            from semireward_tpu_torch.models.utils import load_pretrained
            grafted = load_pretrained(cfg.net,
                                      dict(self.model.named_parameters()),
                                      cfg.pretrain_path)
            with torch.no_grad():
                for n, p in self.model.named_parameters():
                    p.copy_(grafted[n])
            self.logger.info(
                f"pretrained backbone loaded from {cfg.pretrain_path}")
        no_color = bool(cfg.extra.get(
            "randaug_no_color", cfg.dataset in ("tissuemnist", "medmnist")))
        # a full-size JPEG set decodes at img_size / crop_ratio, and the
        # views crop img_size out of it, as the JAX trainer
        src = int(getattr(self.bundle.train_lb, "img_size", cfg.img_size))
        self.aug_spec = AugmentSpec(
            crop_size=cfg.img_size,
            crop_pad=int(cfg.img_size * (1 - cfg.crop_ratio)),
            mean=self.bundle.mean, std=self.bundle.std, randaug_n=3,
            exclude_color=no_color,
            src_size=src if src > cfg.img_size else 0,
        ) if self.modality == "cv" else None
        self.state = init_train_state(cfg, self.alg, self.model, builder,
                                      self.generator, mesh=self.mesh)
        self._step = make_train_step(cfg, self.alg)
        self._schedule = cosine_schedule_with_warmup(
            cfg.lr, cfg.num_train_iter, cfg.num_warmup_iter)
        self.best_metric = -math.inf
        self.best_it = 0
        # the logged LR's offset: Dash's warm-up steps advance the
        # optimizer's schedule, and the step count restarts at 0
        self._lr_log_offset = 0
        self.eval_use_ema = True  # eval CLI --use_train_model flips this
        self.log_history = []  # one dict per log boundary
        self.ckpt_writes = []  # {path, bytes, seconds} per checkpoint file
        self._save_dir = os.path.join(cfg.save_dir, cfg.save_name)
        self._iters_per_epoch = (cfg.num_train_iter // cfg.epoch
                                 if cfg.epoch > 0 else 0)
        self._redone_logged = 0  # JPEG files redone on the host, logged

    @property
    def needs_warmup(self) -> bool:
        """A supervised pre-stage before the first step: the algorithm's,
        or its base's under a wrapper."""
        return bool(self.alg.NEEDS_WARMUP or getattr(
            getattr(self.alg, "base", None), "NEEDS_WARMUP", False))

    def eval_out_key(self) -> str:
        """The head that ``evaluate`` scores at the current step: the
        algorithm's ``eval_out_key(step)`` or ``EVAL_OUT_KEY``, else
        ``logits``."""
        if hasattr(self.alg, "eval_out_key"):
            return self.alg.eval_out_key(int(self.state.step))
        return getattr(self.alg, "EVAL_OUT_KEY", "logits")

    # ------------------------------------------------------------------
    def _to_device(self, arr) -> torch.Tensor:
        """A host array to the device; a tensor (a JPEG batch decoded on
        the card) as it is."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _make_loader(self, seed: Optional[int] = None):
        cfg = self.cfg
        seed = cfg.seed if seed is None else seed
        # on a mesh each batch rank draws its rank-strided share
        world = self.mesh.batch_shards if self.mesh is not None else 1
        rank = self.mesh.batch_index if self.mesh is not None else 0
        bs, ubs = cfg.batch_size // world, cfg.ulb_batch_size // world
        if self.modality in ("nlp", "audio"):
            loader = NLPSSLLoader if self.modality == "nlp" else AudioSSLLoader
            return loader(
                {"train_lb": self.bundle.train_lb,
                 "train_ulb": self.bundle.train_ulb},
                self.collator, bs, ubs, self.alg.BATCH_KEYS, seed=seed,
                rank=rank, world=world)
        # CoSSL's class-balanced labeled and extra unlabeled streams
        tfe = bool(getattr(self.alg, "EXTRA_STREAMS", ()))
        return SSLLoader(self.bundle, bs, ubs, seed=seed, rank=rank,
                         world=world, sampler=cfg.train_sampler,
                         tfe_streams=tfe,
                         tfe_ulb_batch_size=int(cfg.extra.get(
                             "cossl_tfe_u_ratio", 1)) * bs if tfe else 0)

    def make_batch(self, raw: Dict[str, np.ndarray],
                   keys: Optional[Sequence[str]] = None
                   ) -> Dict[str, torch.Tensor]:
        """Raw host batch -> device views + labels/indices the algorithm
        consumes (image views: ``keys``, default the algorithm's). Token
        views go over as they are (no augmentation); waveform crops under
        ``<view>_base`` become that strong view on the device, with draws
        from the trainer's generator."""
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
                                            self.device),
                        exact_reverb=bool(self.cfg.extra.get(
                            "audio_exact_reverb", True)))
                elif k.startswith("x_"):
                    batch[k] = self._to_device(v)
        else:
            batch = augment_views(
                self._to_device(raw["x_lb"]), self._to_device(raw["x_ulb"]),
                self.aug_spec,
                [k for k in (keys or self.alg.BATCH_KEYS)
                 if k.startswith("x_")],
                self.generator,
                weak_ulb_s=getattr(self.alg, "WEAK_ULB_S", False))
            if "x_tfe_lb" in raw:
                # CoSSL's streams: strong views unless cossl_tfe_augment
                # says weak
                from semireward_tpu_torch.imb.cossl import tfe_view
                strong = self.cfg.extra.get("cossl_tfe_augment",
                                            "strong") == "strong"
                for k in ("x_tfe_lb", "x_tfe_ulb"):
                    batch[k] = tfe_view(self._to_device(raw[k]),
                                        self.aug_spec, strong, self.generator)
        for k in ("y_lb", "idx_lb", "idx_ulb", "y_tfe_lb"):
            if k in raw:
                # a regression set's labels stay float32
                dt = (np.float32 if k == "y_lb" and self.cfg.is_regression
                      else np.int64)
                batch[k] = self._to_device(raw[k].astype(dt))
        return batch

    def _train_loader(self):
        """The train stream, restarted at the seed (as the JAX package's
        ``train`` does, a resumed run included), behind a producer thread of
        ``extra['prefetch_depth']`` batches (0: none, the default)."""
        loader = self._make_loader()
        depth = int(self.cfg.extra.get("prefetch_depth",
                                       PREFETCH_DEPTH_DEFAULT))
        return PrefetchLoader(loader, depth=depth) if depth > 0 else loader

    def _sink(self):
        from semireward_tpu_torch.utils.metrics_sink import MetricsSink
        cfg = self.cfg
        if self.rank != 0:
            return _NoSink()
        return MetricsSink(self._save_dir,
                           use_tensorboard=cfg.use_tensorboard,
                           use_wandb=cfg.use_wandb, use_aim=cfg.use_aim,
                           run_name=cfg.save_name,
                           config={k: v for k, v in cfg.to_dict().items()
                                   if isinstance(v, (int, float, str, bool))})

    def train(self, num_iters: Optional[int] = None,
              eval_hook: Optional[Callable] = None,
              step_hook: Optional[Callable] = None) -> Dict[str, float]:
        """Run steps ``state.step .. num_iters``. ``step_hook(step, metrics)``
        sees each step's device metrics (no host sync)."""
        cfg = self.cfg
        num_iters = num_iters or cfg.num_train_iter
        if self.needs_warmup:
            if self.state.step == 0:
                self.warmup()
            # the warm-up's steps stay in the optimizer's count (and in a
            # resumed checkpoint's), so the logged LR runs offset as the
            # applied one does
            self._lr_log_offset = int(cfg.extra.get("num_wu_iter",
                                                    cfg.num_wu_iter))
        loader = self._train_loader()
        sink = self._sink()
        log = self.logger.info
        results: Dict[str, float] = {}
        t0 = time.time()
        prefetch_acc = 0.0  # host wait for the next raw batch
        window_start = self.state.step
        try:
            for it in range(self.state.step, num_iters):
                tp = time.time()
                raw = next(loader)
                prefetch_acc += time.time() - tp
                metrics = self._step(self.state, self.make_batch(raw),
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
                    lr = self._schedule(step_now + self._lr_log_offset)
                    log(f"it {step_now}/{num_iters} "
                        + " ".join(f"{k}={v:.4f}"
                                   for k, v in sorted(fetched.items()))
                        + f" lr={lr:.2e} steps/s={sps:.2f}")
                    self.log_history.append({"step": step_now, "steps": n,
                                             "seconds": dt, **fetched})
                    per = max(n, 1)
                    sink.log({**{f"train/{k}": v for k, v in fetched.items()},
                              "lr": lr, "train/steps_per_sec": sps,
                              "train/prefetch_time": prefetch_acc / per,
                              "train/run_time": max(
                                  dt / per - prefetch_acc / per, 0.0)},
                             step_now)
                    prefetch_acc = 0.0
                    self._log_jpeg_redo()
                    t0, window_start = time.time(), step_now
                # the host's work at an epoch boundary (SAW's and ADSH's
                # refits, CoSSL's warm start)
                if (self._iters_per_epoch
                        and step_now % self._iters_per_epoch == 0
                        and hasattr(self.alg, "on_epoch_end")):
                    new_state = self.alg.on_epoch_end(self, self.state)
                    if new_state is not None:
                        self.state = new_state
                if step_now % cfg.num_eval_iter == 0 or step_now == num_iters:
                    eval_m = self.evaluate()
                    key = "top-1-acc" if not cfg.is_regression else "mse"
                    score = (eval_m[key] if not cfg.is_regression
                             else -eval_m[key])
                    if score > self.best_metric:
                        self.best_metric, self.best_it = score, step_now
                        self._write(ckpt.BEST, step_now, eval_m)
                    self._write(ckpt.LATEST, step_now, eval_m)
                    log(f"eval @ {step_now}: "
                        + " ".join(f"{k}={v:.4f}" for k, v in eval_m.items())
                        + f" (best {self.best_metric:.4f} @ {self.best_it})")
                    sink.log({f"eval/{k}": v for k, v in eval_m.items()},
                             step_now)
                    results = {f"eval/{k}": v for k, v in eval_m.items()}
                    results["eval/best_acc"] = self.best_metric
                    results["eval/best_it"] = self.best_it
                    if eval_hook:
                        eval_hook(step_now, eval_m)
                    prefetch_acc = 0.0
                    t0, window_start = time.time(), step_now
        finally:
            if isinstance(loader, PrefetchLoader):
                loader.close()  # stop the producer, on an error too
            sink.close()
        # the JAX package's after-run protocol: score the test split, where
        # the data has one, with the best checkpoint's weights (read from
        # the file; the live state is untouched)
        best = os.path.join(self._save_dir, ckpt.BEST)
        have_best = os.path.exists(best)
        if self.world > 1 and getattr(self.bundle, "test", None) is not None:
            # one decision on every rank (the eval is collective): the file
            # is rank 0's, so without a shared file system no rank reads it
            have = torch.tensor([int(have_best)], device=self.device)
            torch.distributed.all_reduce(have,
                                         op=torch.distributed.ReduceOp.MIN)
            if have_best and not int(have):
                log("best-ckpt test eval skipped: multi-host run without a "
                    "shared filesystem (model_best.ckpt on rank 0 only)")
            have_best = bool(int(have))
        if getattr(self.bundle, "test", None) is not None and have_best:
            test_m = self.evaluate(split="test", weights=self._file_weights(
                best))
            results.update({f"test/{k}": v for k, v in test_m.items()})
            log("test (best ckpt): "
                + " ".join(f"{k}={v:.4f}" for k, v in test_m.items()))
        return results

    def jpeg_counts(self):
        """A JPEG-folder bundle's decode counts: images nvJPEG decoded on
        the card, and the files it rejected, which PIL decoded instead
        (``None`` for array data)."""
        sets = [d for d in (self.bundle.train_lb, self.bundle.train_ulb,
                            self.bundle.eval)
                if hasattr(d, "redone_on_host")]
        if not sets:
            return None
        return (sum(d.decoded_on_card for d in sets),
                set().union(*(d.redone_on_host for d in sets)))

    def _log_jpeg_redo(self):
        counts = self.jpeg_counts()
        if counts and len(counts[1]) > self._redone_logged:
            self._redone_logged = len(counts[1])
            self.logger.info(
                f"jpeg: {counts[0]} images decoded on the card; "
                f"{len(counts[1])} files nvJPEG rejected, decoded on the "
                f"host: {', '.join(sorted(counts[1])[:8])}")

    def warmup(self):
        """Dash's supervised pre-stage: ``num_wu_iter`` steps of the train
        step on a labeled-only loss (``SupervisedWarmup``: the same model,
        optimizer and EMA; the loader at ``seed + 99``), then ``rho_init``
        = the eval CE loss, and the step count back to 0. The optimizer's
        count, and so its schedule, keeps the steps."""
        cfg = self.cfg
        state = self.state
        warm = SupervisedWarmup(cfg, device=self.device)
        step = make_train_step(cfg, warm)
        loader = self._make_loader(seed=cfg.seed + 99)
        n = int(cfg.extra.get("num_wu_iter", cfg.num_wu_iter))
        for i in range(n):
            batch = self.make_batch(next(loader), keys=warm.BATCH_KEYS)
            metrics = step(state, batch, self.generator)
            if (i + 1) % cfg.num_wu_eval_iter == 0:
                self.logger.info(f"warmup {i + 1}/{n} "
                                 f"sup_loss={float(metrics['sup_loss']):.4f}")
        rho_init = self.evaluate()["loss"]
        state.algo = self.alg.set_rho_init(state.algo, rho_init)
        state.step = 0
        self.logger.info(f"warmup finished; rho_init={rho_init:.4f}")
        return rho_init

    def _write(self, name: str, step_now: int, eval_m: Dict[str, float]):
        path = os.path.join(self._save_dir, name)
        t0 = time.time()
        # every rank gathers (a collective on a mesh), rank 0 writes
        size = ckpt.save_checkpoint(path, self.state,
                                    self._ckpt_extra(step_now, eval_m),
                                    write=self.rank == 0)
        if self.rank == 0:
            self.ckpt_writes.append({"path": path, "bytes": size,
                                     "seconds": time.time() - t0})

    def _ckpt_extra(self, step_now: int, eval_m: Dict[str, float]) -> Dict:
        """Checkpoint metadata: the best-model tracking survives a resume,
        as in the reference's save dict."""
        return {"it": step_now, "eval": eval_m,
                "best_metric": self.best_metric, "best_it": self.best_it,
                "algorithm": self.cfg.algorithm}

    def load(self, path: str) -> Dict:
        """Resume from a checkpoint of this configuration: the whole state
        and the best-model tracking, so a later eval cannot overwrite
        ``model_best.ckpt`` with a worse model."""
        extra = ckpt.load_checkpoint(path, self.state)
        if "best_metric" in extra:
            self.best_metric = float(extra["best_metric"])
            self.best_it = int(extra.get("best_it", 0))
        self.logger.info(f"resumed from {path} at it={extra.get('it')}")
        return extra

    def load_weights(self, path: str) -> Dict:
        """Algorithm-agnostic weight load for offline eval: parameters,
        buffers and EMA only (``checkpoint.load_eval_weights``)."""
        return ckpt.load_eval_weights(path, self.state)

    def save(self, path: str) -> int:
        return ckpt.save_checkpoint(path, self.state,
                                    self._ckpt_extra(self.state.step, {}),
                                    write=self.rank == 0)

    def _file_weights(self, path: str) -> Dict[str, torch.Tensor]:
        """The eval weights of a checkpoint file of this run (EMA or live
        parameters, as ``eval_use_ema`` says, and the buffers), on the
        device, for ``evaluate(weights=...)``."""
        src = ckpt.read_payload(path)["state"]
        group = "ema." if self.eval_use_ema else "model."
        layout = self.state.layout
        out = {n: src[group + n] for n, _ in self.model.named_parameters()}
        if layout is not None:
            # the forward's layout: whole FSDP leaves, TP blocks
            out = {n: layout.local(n, v, ("model",)) for n, v in out.items()}
        out.update({n: src["model." + n]
                    for n, _ in self.model.named_buffers()})
        return {n: v.to(self.device) for n, v in out.items()}

    def _eval_weights(self) -> Dict[str, torch.Tensor]:
        layout = self.state.layout
        if not self.eval_use_ema and layout is None:
            return {}
        names = [n for n, _ in self.model.named_parameters()]
        src = (self.state.ema if self.eval_use_ema
               else [p.detach() for p in self.model.parameters()])
        if layout is not None:
            # the forward's layout: the FSDP leaves gathered whole
            src = [layout.full(n, t, ("fsdp",)) for n, t in zip(names, src)]
        return dict(zip(names, src))

    @torch.no_grad()
    def _logits(self, x, weights: Optional[Dict[str, torch.Tensor]] = None,
                out_key: str = "logits") -> np.ndarray:
        """Logits of ``weights`` (default: the EMA weights, or the live ones
        with ``eval_use_ema`` off; the live buffers) for an image batch, a
        token dict or a waveform batch (no normalization for tokens and
        waveforms), from the head ``out_key`` (``logits`` where the net has
        no such head)."""
        if weights is None:
            weights = self._eval_weights()
        if isinstance(x, dict):
            xs = {k: self._to_device(v) for k, v in x.items()}
        elif self.modality == "audio":
            xs = self._to_device(x)
        else:
            xs = normalize(self._to_device(x), self.aug_spec.mean,
                           self.aug_spec.std)
        out = functional_call(self.model, weights, (xs,), {"train": False})
        return out.get(out_key, out["logits"]).float().cpu().numpy()

    def _eval_batches(self, ds):
        """Fixed-shape eval batches with a validity mask; images wider than
        ``img_size`` center-cropped to it, NLP texts tokenized into one
        bucket per batch, waveforms cropped / padded to the bucket."""
        bs = self.cfg.eval_batch_size
        if self.modality == "cv":
            S = self.cfg.img_size
            for b in eval_batches(ds, bs):
                if b["x"].shape[1] > S:
                    off = (b["x"].shape[1] - S) // 2
                    # a full-size JPEG set decodes at img_size /
                    # crop_ratio: the reference's CenterCrop
                    b["x"] = b["x"][:, off:off + S, off:off + S]
                yield b
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

    def evaluate(self, split: str = "eval",
                 weights: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, float]:
        """Metrics of the EMA weights (or ``weights``, see ``_logits``) on
        the eval split, or on the test split where ``split='test'`` and the
        data has one, from the head that ``eval_out_key`` names."""
        ds = getattr(self.bundle, "test", None) if split == "test" else None
        if weights is None:
            weights = self._eval_weights()
        out_key = self.eval_out_key()
        preds, trues, logits_all = [], [], []
        for b in self._eval_batches(ds if ds is not None
                                    else self.bundle.eval):
            logits = self._logits(b["x"], weights, out_key)[b["mask"]]
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
