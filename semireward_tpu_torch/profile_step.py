"""Where the time of the port's training step goes, on one CUDA card.

    python -m semireward_tpu_torch.profile_step [--config <yaml>]
        [--set key=value ...] [--extra key=value ...] [--steps 20]
        [--warmup 30] [--row-shards 1] [--out profile.json]

Builds the port's Trainer on ``--config`` (default: the headline
config/SemiReward/usb_cv/flexmatch/flexmatch_cifar100_200_0.yaml) as
:func:`synthetic_config` sets it up (synthetic data, random weights,
start_timing 10 so the measured steps are in stage 2), with ``--set``
overrides on top and ``--extra`` keys in its ``extra`` dict (``--extra
sr_reforward=8``: SemiReward's reference-equivalent arm), runs ``--warmup``
steps, then traces ``--steps`` steps with
torch.profiler (CPU and CUDA). ``--row-shards N`` makes the measured steps
draw as rank 0 of N batch shards does (``rng.set_shards``: every draw for
the batch rows at N times the rows, then cut), which shows what that
costs one rank. Prints one JSON object: wall time per step
(under the profiler, and for the same steps run once before without it),
the peak device memory of the unprofiled steps, device busy time per step
(union of kernel intervals) and the idle share,
and device time per kernel group (the random draws' own) (the fused MLP's K1 and K3 and the flash
attention kernels by their own names, other GEMMs, convolutions,
elementwise/reduction, ...) and per top kernel. Takes the audio config
(config/SemiReward/usb_audio/flexmatch/flexmatch_esc50_250_0.yaml), the
other SemiReward variants (e.g.
config/SemiReward/usb_cv/freematch/freematch_cifar100_200_0.yaml) and the
classic_cv WRN-28-2 ones
(config/SemiReward/classic_cv/pseudolabel/pseudolabel_cifar100_10000_0.yaml)
as the others. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import torch
import yaml

HEADLINE = "config/SemiReward/usb_cv/flexmatch/flexmatch_cifar100_200_0.yaml"
# the seeded corpora of data/nlp.py and data/audio.py:write_synthetic_corpus
# (git-ignored)
_BUILD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
SYNTH_TEXT = os.path.join(_BUILD, "synth_text")
SYNTH_AUDIO = os.path.join(_BUILD, "synth_audio")
SYNTH_BIO = os.path.join(_BUILD, "synth_bio")
SYNTH_STL10 = os.path.join(_BUILD, "synth_stl10")
# data/datasets.py:write_synthetic_jpeg_folder's ImageNet-layout corpora
SYNTH_JPEG = {"imagenet": os.path.join(_BUILD, "synth_imagenet"),
              "imagenet127": os.path.join(_BUILD, "synth_imagenet127")}
# data/datasets.py:write_synthetic_regression's npz sets (agedb, ...)
SYNTH_REGRESSION = os.path.join(_BUILD, "synth_regression")


def synthetic_config(path: str, overrides=None):
    """``path``'s config as the smoke run, the profile and the A/B run it:
    random weights and no resume (the repo ships no weights), start_timing
    10 and N_k 10 (stage 2 and the reward filter within a short run), and
    synthetic data. For an image net: CIFAR-shaped images (``dataset
    synthetic``; 2048 train images, or twice the YAML's ``num_labels``
    where that is more, so that the classic_cv YAMLs' 10000 labels split,
    or on an imbalanced YAML ``num_classes * (num_labels +
    ulb_num_labels)``, so that every class holds the head class's counts;
    ``synthetic_train`` overrides it), except on an STL-10 YAML, where the
    seeded STL-10-layout corpus under ``build/synth_stl10`` (96 px) stands
    in, and on an ``imagenet`` / ``imagenet127`` YAML, where a seeded
    ImageNet-layout JPEG folder of that many train images and
    ``synthetic_test`` (256) val images of the YAML's classes does
    (``build/synth_imagenet``, ``build/synth_imagenet127``), decoded as the
    YAML's dataset; on a regression set (``agedb``, ``imdb_wiki``,
    ``rcf_mnist``) a seeded npz of that many train images (1024 by
    default) and ``synthetic_test`` (128) test images at ``img_size``
    under ``build/synth_regression``; for a text net the seeded
    aclImdb-layout corpus,
    written under ``build/synth_text`` on first use (for a ``dnabert*`` net
    the seeded CSV k-mer corpus, ``data/bio.py:write_synthetic_bio``, under
    ``build/synth_bio``); for an audio net the seeded ESC-50-layout corpus
    under ``build/synth_audio``. ``overrides``
    go on top."""
    from semireward_tpu_torch import config as config_lib
    from semireward_tpu_torch.data.cv_extra import REGRESSION_DATASETS
    from semireward_tpu_torch.data.modality import modality_of

    overrides = {"use_pretrain": False, "resume": False, "start_timing": 10,
                 "N_k": 10, **(overrides or {})}
    cfg = config_lib.from_yaml(path, overrides)
    modality = modality_of(cfg.net)
    if modality == "cv" and cfg.dataset == "stl10":
        # the dataset's name picks algorithm branches (SimMatch's EMA
        # teacher), so STL-10 keeps its name, its 96 px and its layout
        from semireward_tpu_torch.data.datasets import write_synthetic_stl10
        write_synthetic_stl10(SYNTH_STL10)
        return config_lib.from_yaml(path, {"data_dir": SYNTH_STL10,
                                           **overrides})
    if modality == "cv" and cfg.dataset in REGRESSION_DATASETS:
        from semireward_tpu_torch.data.datasets import (
            write_synthetic_regression)
        write_synthetic_regression(
            SYNTH_REGRESSION, cfg.dataset, seed=cfg.seed,
            n_train=int(cfg.extra.get("synthetic_train", 1024)),
            n_test=int(cfg.extra.get("synthetic_test", 128)),
            size=cfg.img_size)
        return config_lib.from_yaml(path, {"data_dir": SYNTH_REGRESSION,
                                           **overrides})
    if modality == "cv":
        n = max(2048, 2 * cfg.num_labels)
        if cfg.ulb_num_labels:
            # an imbalanced split names its head class's labeled and
            # unlabeled counts: every class holds both
            n = max(n, cfg.num_classes * (cfg.num_labels
                                          + int(cfg.ulb_num_labels)))
        n = int(cfg.extra.get("synthetic_train", n))
        if cfg.dataset in SYNTH_JPEG:
            from semireward_tpu_torch.data.datasets import (
                write_synthetic_jpeg_folder)
            root = write_synthetic_jpeg_folder(
                SYNTH_JPEG[cfg.dataset], cfg.num_classes, n,
                int(cfg.extra.get("synthetic_test", 256)))
            return config_lib.from_yaml(path, {"data_dir": root,
                                               **overrides})
        return config_lib.from_yaml(path, {
            "dataset": "synthetic", "synthetic_train": n, **overrides})
    if cfg.net.startswith("dnabert"):
        from semireward_tpu_torch.data.bio import write_synthetic_bio
        write_synthetic_bio(SYNTH_BIO, cfg.dataset, cfg.num_classes)
        return config_lib.from_yaml(path, {"data_dir": SYNTH_BIO,
                                           **overrides})
    if modality == "nlp":
        from semireward_tpu_torch.data.nlp import write_synthetic_corpus
        root = SYNTH_TEXT
    else:
        from semireward_tpu_torch.data.audio import write_synthetic_corpus
        root = SYNTH_AUDIO
    write_synthetic_corpus(root, cfg.dataset, cfg.num_classes)
    return config_lib.from_yaml(path, {"data_dir": root, **overrides})


def _group(name: str) -> str:
    n = name.lower()
    # the port's own kernels live in an anonymous namespace of csrc/*.cu
    # (a template's name carries its return type, a plain function's not)
    ours = n.startswith(("void (anonymous namespace)::",
                         "(anonymous namespace)::"))
    # K1's, K2's and K3's kernels by their k1_ / k2_ / k3_ prefix, before
    # any gemm match
    if ours and "::k2_fwd_" in n:
        return "flash_attention_fwd"
    if ours and "::k2_bwd_" in n:
        return "flash_attention_bwd"
    if ours and "::k3_fwd_" in n:
        return "fused_mlp_blocked_fwd"
    if ours and "::k3_bwd_" in n:
        return "fused_mlp_blocked_bwd"
    if ours and "::k1_fwd_" in n:
        return "fused_mlp_fwd"
    if ours and "::k1_bwd_" in n:
        return "fused_mlp_bwd"
    # torch's random draws (uniform, normal, randint, dropout's mask)
    if "distribution_" in n or "fused_dropout" in n:
        return "random draws"
    # cuDNN's convolutions, some of them CUTLASS kernels by name
    if "bn_" in n or "batch_norm" in n or "batchnorm" in n:
        return "batch_norm (fwd + bwd)"
    if any(s in n for s in ("conv", "dgrad", "wgrad", "fprop")):
        return "conv (patch embed; WRN; audio feature extractor, pos conv)"
    if any(s in n for s in ("gemm", "cutlass", "sm90", "matmul", "nvjet")):
        return "gemm (attention, qkv/proj, head, rewarder)"
    if "softmax" in n:
        return "softmax"
    if "layer_norm" in n or "layernorm" in n or "gammabeta" in n:
        return "layer_norm"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer/EMA (foreach)"
    if "copy_kernel" in n:
        return "copies and casts"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    return "other elementwise/reduction/index"


def _union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=HEADLINE)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="config override (repeatable)")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a key of the config's extra dict, read as YAML "
                         "(repeatable; sr_reforward is read there)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--row-shards", type=int, default=1,
                    help="draw in the measured steps as rank 0 of this "
                         "many batch shards does")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from semireward_tpu_torch.core.trainer import Trainer

    overrides = dict(kv.split("=", 1) for kv in args.set)
    # the warm-up's eval writes its checkpoints into a scratch directory
    with tempfile.TemporaryDirectory() as scratch:
        cfg = synthetic_config(args.config, {"num_log_iter": 10 ** 9,
                                             "save_dir": scratch,
                                             **overrides})
        cfg.extra.update((k, yaml.safe_load(v)) for k, v in (
            kv.split("=", 1) for kv in args.extra))
        trainer = Trainer(cfg)
        trainer.train(num_iters=args.warmup)
        torch.cuda.synchronize()

    from semireward_tpu_torch import rng

    loader = trainer._make_loader()
    batches = [next(loader) for _ in range(args.steps)]
    rng.set_shards(rows=(0, args.row_shards))
    try:
        # the same steps once without the profiler, whose per-launch cost
        # inflates the host's share
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for raw in batches:
            trainer._step(trainer.state, trainer.make_batch(raw),
                          trainer.generator)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for raw in batches:
                trainer._step(trainer.state, trainer.make_batch(raw),
                              trainer.generator)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        rng.set_shards()

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group, by_name = defaultdict(float), defaultdict(float)
    intervals = []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        intervals.append((e.time_range.start, e.time_range.end))
        by_group[_group(e.name)] += dur
        by_name[e.name] += dur
    busy_us = _union_us(intervals)
    n = args.steps
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {
        "card": card, "config": args.config, "overrides": overrides,
        "steps": n, "row_shards": args.row_shards,
        "peak_device_bytes": peak,
        "wall_ms_per_step": wall * 1e3 / n,
        "unprofiled_wall_ms_per_step": plain_wall * 1e3 / n,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e6 / wall),
        "kernel_launches_per_step": len(kernels) / n,
        "device_ms_per_step_by_group": {
            k: v / 1e3 / n for k, v in sorted(by_group.items(),
                                             key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {
            k[:120]: v / 1e3 / n for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:15]},
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
