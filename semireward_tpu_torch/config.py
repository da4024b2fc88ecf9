"""Typed configuration with reference-YAML key parity.

Copy of ``semireward_tpu/config.py`` (framework-free): the same YAML files
load into the same ``Config`` fields through either package. The port keeps
its own copy because importing the JAX package imports jax.

The reference drives everything from 1,158 YAML files parsed through three
argparse passes with YAML overwrite (reference: train.py:29-269,
semilearn/core/utils/misc.py:10-27). Here the same YAML files load into a
single typed dataclass; per-algorithm defaults (the reference's
``get_argument()`` lists, e.g. srflexmatch/srflexmatch.py:233-246) are merged
from each algorithm module's ``DEFAULTS`` dict before user overrides apply.

Keys that only make sense for the torch/NCCL runtime (``gpu``, ``dist_url``,
``dist_backend``, ``multiprocessing_distributed``, ``world_size``, ``rank``,
``num_workers``, ``amp``) are accepted and recorded but do not steer the TPU
runtime — parallelism is declared via ``mesh_shape`` and handled by
jax.sharding, and mixed precision via ``compute_dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass
class Config:
    # --- experiment / run ---
    algorithm: str = "fixmatch"
    save_dir: str = "./saved_models"
    save_name: str = "run"
    resume: bool = False
    load_path: str = ""
    overwrite: bool = True
    seed: int = 0
    use_tensorboard: bool = False
    use_wandb: bool = False
    use_aim: bool = False

    # --- schedule ---
    epoch: int = 1
    num_train_iter: int = 20
    num_eval_iter: int = 10
    num_log_iter: int = 5
    num_warmup_iter: int = 0

    # --- batches ---
    batch_size: int = 8
    eval_batch_size: int = 16
    uratio: float = 1.0  # ulb batch = uratio * batch_size

    # --- data ---
    dataset: str = "cifar10"
    data_dir: str = "./data"
    num_classes: int = 10
    num_labels: int = 40
    img_size: int = 32
    crop_ratio: float = 0.875
    max_length: int = 512            # NLP token cap (reference train.py:199)
    max_length_seconds: float = 4.0  # audio crop (reference train.py:202)
    sample_rate: int = 16000
    train_sampler: str = "RandomSampler"
    include_lb_to_ulb: bool = True
    lb_imb_ratio: float = 1.0
    ulb_imb_ratio: float = 1.0
    ulb_num_labels: Optional[int] = None
    num_workers: int = 0

    # --- model ---
    net: str = "wrn_28_2"
    net_from_name: bool = False
    use_pretrain: bool = False
    pretrain_path: str = ""

    # --- optimization ---
    optim: str = "SGD"
    lr: float = 0.03
    momentum: float = 0.9
    weight_decay: float = 5e-4
    layer_decay: float = 1.0
    clip: float = 0.0           # grad-norm clip; 0 disables (reference `clip`)
    clip_grad: float = 0.0      # alias used by some configs
    amp: bool = False
    ema_m: float = 0.999        # EMA of model weights for eval
    use_cat: bool = True        # concat lb+ulb into one forward

    # --- SSL common knobs (per-algorithm defaults may override) ---
    ulb_loss_ratio: float = 1.0   # lambda_u
    hard_label: bool = True
    T: float = 0.5
    p_cutoff: float = 0.95
    thresh_warmup: bool = True
    unsup_warm_up: float = 0.4
    ema_p: float = 0.999
    ent_loss_ratio: float = 0.01
    use_quantile: bool = False
    clip_thresh: bool = False
    dist_align: bool = True
    dist_uniform: bool = True
    n_sigma: int = 2
    per_class: bool = False
    use_flex: bool = False
    # uda
    tsa_schedule: str = "none"
    # vat
    vat_eps: float = 6.0
    vat_embed: bool = False
    ent_loss_ratio_vat: float = 0.06
    # mixmatch / remixmatch
    mixup_alpha: float = 0.5
    mixup_manifold: bool = False
    kl_loss_ratio: float = 0.5
    rot_loss_ratio: float = 0.5
    unsup_warm_up_remix: float = 1 / 64
    # comatch / simmatch
    contrast_p_cutoff: float = 0.8
    contrast_loss_ratio: float = 1.0
    proj_size: int = 128
    queue_batch: int = 128
    smoothing_alpha: float = 0.9
    da_len: int = 32
    in_loss_ratio: float = 1.0
    # crmatch
    rot_loss_ratio_cr: float = 1.0
    # dash
    gamma: float = 1.27
    C: float = 1.0001
    rho_min: float = 0.05
    num_wu_iter: int = 2048
    num_wu_eval_iter: int = 100
    # pseudolabel
    unsup_warm_up_pl: float = 0.4
    # regression
    reg_loss: str = "l1"
    is_regression: bool = False

    # --- SemiReward (reference srflexmatch.py:233-246, config above) ---
    start_timing: int = 20000
    feature_dim: int = 384
    sr_lr: float = 0.0005
    N_k: int = 10
    sr_ema: bool = True
    sr_ema_m: float = 0.999
    sr_max_sampling: int = 8   # max_sampling_time in sr_decay (algorithmbase.py:177)
    # TPU deviation knob: the reference re-forwards the backbone sr_decay()
    # times and keeps only the LAST loss (srflexmatch.py:75-104) — iterations
    # are pure recompute. 1 = single forward (identical loss). Set >1 only to
    # mimic reference wall-clock.
    sr_reforward: int = 1
    # Beyond-reference (opt-in): per-sample reward attention + ground-truth
    # candidate training for the rewarder. The faithful architecture scores
    # per LABEL within a batch (batch-shared context, semireward.py:60-66)
    # and its training never visits real label embeddings — see
    # docs/quality.md. False = exact reference semantics.
    sr_per_sample: bool = False

    # --- imbalanced suite ---
    imb_algorithm: Optional[str] = None

    # --- TPU runtime ---
    mesh_shape: Tuple[int, ...] = (-1,)           # -1 = all devices on 'data'
    mesh_axes: Tuple[str, ...] = ("data",)
    compute_dtype: str = "bfloat16"               # matmul/conv compute dtype
    param_dtype: str = "float32"
    donate_state: bool = True
    gradient_checkpointing: bool = False

    # legacy torch-runtime keys: accepted, recorded, unused on TPU
    world_size: int = 1
    rank: int = 0
    gpu: Any = None
    multiprocessing_distributed: bool = False
    dist_url: str = ""
    dist_backend: str = ""

    # anything unrecognized lands here (never silently dropped)
    extra: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def lambda_u(self) -> float:
        return self.ulb_loss_ratio

    @property
    def ulb_batch_size(self) -> int:
        return max(1, int(self.batch_size * self.uratio))

    @property
    def grad_clip(self) -> float:
        return self.clip if self.clip > 0 else self.clip_grad

    @property
    def use_hard_label(self) -> bool:
        return self.hard_label

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}

# reference key -> Config field renames
_ALIASES = {
    "clip_grad": "clip_grad",
    "ent_loss_ratio": "ent_loss_ratio",
}

_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(Config) if f.type in ("bool", bool)
}


def _coerce(name: str, value: Any) -> Any:
    """YAML/CLI values arrive as strings ('True', '4', '0.03', '(1,)') —
    the reference's argparse types do this coercion per-flag
    (train.py:29-269); here it is generic."""
    if isinstance(value, str):
        v = value.strip()
        if v in ("True", "true"):
            return True
        if v in ("False", "false"):
            return False
        if v in ("None", "null", ""):
            return None
        if v.startswith(("(", "[")) and v.endswith((")", "]")):
            try:
                import ast

                return tuple(ast.literal_eval(v))
            except (ValueError, SyntaxError):
                # bare-word tuples like "(data,fsdp)" — mesh axis names
                inner = [s.strip() for s in v[1:-1].split(",") if s.strip()]
                if inner and all(s.isidentifier() for s in inner):
                    return tuple(inner)
                return value
        try:
            return int(v)
        except ValueError:
            pass
        try:
            return float(v)
        except ValueError:
            pass
    return value


def algorithm_defaults(algorithm: str) -> Dict[str, Any]:
    """Per-algorithm default overrides, mirroring the reference's
    ``get_argument()`` injection (train.py:246-268)."""
    from semireward_tpu_torch import algorithms as _algos  # noqa: F401  (registers)
    from semireward_tpu_torch.registry import ALGORITHMS

    if algorithm in ALGORITHMS:
        mod = ALGORITHMS.get(algorithm)
        return dict(getattr(mod, "DEFAULTS", {}))
    return {}


def from_dict(d: Dict[str, Any], apply_alg_defaults: bool = True) -> Config:
    d = {k: _coerce(k, v) for k, v in d.items()}
    base: Dict[str, Any] = {}
    if apply_alg_defaults and "algorithm" in d:
        try:
            base.update(algorithm_defaults(str(d["algorithm"])))
        except Exception:
            pass
    extra: Dict[str, Any] = {}
    for k, v in d.items():
        key = _ALIASES.get(k, k)
        if key in _FIELD_NAMES and key != "extra":
            if v is None and key in ("ulb_num_labels", "imb_algorithm", "gpu"):
                base[key] = None
            elif v is not None:
                if key in ("mesh_shape", "mesh_axes") and isinstance(v, (list, tuple)):
                    base[key] = tuple(v)
                else:
                    base[key] = v
        else:
            extra[k] = v
    cfg = Config(**base)
    cfg.extra.update(extra)
    # regression task detection (reference algorithmbase.py:125-130 keys on
    # loss_type != 'ce_loss'; its regression datasets are the num_classes=1
    # ones — agedb / imdb_wiki / rcf_mnist)
    if "is_regression" not in d:
        lt = cfg.extra.get("loss_type")
        if (lt is not None and lt != "ce_loss") or cfg.num_classes == 1:
            cfg.is_regression = True
    return cfg


def from_yaml(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    if overrides:
        d.update(overrides)
    return from_dict(d)


def get_config(d: Optional[Dict[str, Any]] = None, **kw) -> Config:
    """Dict-based entry mirroring the reference lighting API
    (semilearn/lighting/config.py:15-158)."""
    merged = dict(d or {})
    merged.update(kw)
    return from_dict(merged)
