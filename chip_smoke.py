#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA source of ``semireward_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. kernel phases: hold each kernel against its plain PyTorch version and
   time kernel, plain version and the one-call PyTorch equivalent (yardstick
   only) beside the bound:
   - K1, the fused MLP at C 128-384 (forward: two wgmma GEMMs, the GELU
     one ping-pong; backward: three and a fixed-order reduction), at the
     headline shape (M 24*257 = 6168, C 384, H 1536), the headline eval
     shape (M 16*257 = 4112), the 8-image forwards' (M 2056), DeFixMatch's
     and CoMatch's (M 32*257 = 8224), CRMatch's (M 56*257 = 14392),
     SimMatch's on STL-10 at 96 px (M 24*2305 = 55320; the EMA teacher's
     18440, the eval's 36880), ViT-Ti's width (M 6168, C 192, H 768) and a
     small ragged one, the backward bit-equal across two launches, with its
     breakdown by GEMM at the headline shape (``k3_profile.py``) and
     ptxas's registers and spills for every K1 kernel (none may spill);
   - K3, the hidden-blocked fused MLP (forward: two wgmma GEMMs; backward:
     three and a fixed-order reduction), at the HuBERT-base train shape
     (M 24*199 = 4776, C 768, H 3072), the BERT-base one (M 12*512 = 6144),
     CoMatch's on BERT-base (M 16*512 = 8192), ViT-B/16's at 224 px (M
     768*197 = 151296; its breakdown by GEMM too) and a small ragged M, and
     at the widths it takes besides 768 (``K3_WIDE_SHAPES``): DINOv2
     ViT-L/14's C 1024, H 4096 at its train shape (M 48*257 = 12336,
     timed, with its breakdown by GEMM) and M 1 and 129, and C 512 at a
     ragged M; the backward bit-equal across two launches, with
     each timed row's TFLOP/s and share of its bound and the tile plan;
     ptxas's registers and spills for every K3 kernel (none may spill);
   - K2, flash attention (forward; dq + dk/dv, all three wgmma + TMA
     kernels with two free-running consumer warpgroups and helper warps
     that stage each step's bias and keep bits), at the BERT-base train
     shape (12 x 12 heads, N 512, key-padding bias, dropout 0.1), the same
     without dropout (the difference is the hash's cost), HuBERT-base's (24
     x 12 heads, N 199, dropout 0.1, no bias), CoMatch's on BERT-base (16 x
     12 heads, N 512, bias, dropout 0.1; timed), SimMatch's on STL-10 (24,
     16 and 8 x 6 heads, N 2305), ViT-S's (24 x 6 heads, N 257,
     no bias; also B 8, 32 and 56, the last timed: CRMatch's), ViT-B/16's
     at 224 px (768 x 12 heads, N 197; timed, and its time by kernel) and small
     ragged shapes (N 1, 77, 130, 1000): the forward's keep
     bits equal to pack_keep_bits(attention_keep_mask), the backward
     bit-equal across two launches; the dropout stream read out of the
     forward kernel and the dq and dk/dv kernels' masks read out of the
     backward, bit for bit, at the BERT shape; a timed row per model shape
     beside SDPA; flash against the unfused attention at the three model
     shapes; K2's device time by kernel, launches and host time a call at
     the three shapes (``k3_profile.flash_breakdown``); and ptxas's
     registers and spills for every K2 kernel (none may spill);
4. train phases, each with every kernel count set to 0 just before it and
   read just after, exact launch counts (no MLP of any phase takes the two
   dense layers: ``fused_mlp_dense`` 0), losses, SemiReward and FlexMatch
   state checked, an eval at the end, peak device memory printed, all on
   the port's defaults on a card:
   - ViT: the headline config
     (``config/SemiReward/usb_cv/flexmatch/flexmatch_cifar100_200_0.yaml``,
     SRFlexMatch, ViT-S/2-32 at full width and depth, 8+8 images) on
     synthetic images for ``TRAIN_STEPS`` steps through K1 and K2 (no
     bias);
   - BERT: the usb_nlp config
     (``config/SemiReward/usb_nlp/flexmatch/flexmatch_aclImdb_100_0.yaml``,
     SRFlexMatch, BERT-base at full width and depth, max_length 512, 4+4
     texts, ``use_cat``) on a synthetic aclImdb-layout corpus for
     ``BERT_STEPS`` steps, every attention call on K2, every MLP on K3;
   - audio: the usb_audio config
     (``config/SemiReward/usb_audio/flexmatch/flexmatch_esc50_250_0.yaml``,
     SRFlexMatch, HuBERT-base at full width and depth, 4 s at 16 kHz = 199
     frames, 8+8 clips, ``use_cat``: M = 4776 rows in every MLP) on a
     synthetic ESC-50-layout corpus for ``AUDIO_STEPS`` steps, every MLP
     on K3 and every attention call on K2 (no bias, dropout 0.1; eval too,
     at N 199 >= 128), the strong views' sox effects on the device;
   - the other SemiReward variants on the ViT-S/2-32 path (K1 and K2):
     SRFreeMatch (``usb_cv/freematch/freematch_cifar100_200_0.yaml``,
     ``FREE_STEPS`` steps; its stage-2 remask applies the FreeMatch hook
     sr_decay(step) times, up to 18,619 at step 11), SRSoftMatch
     (``usb_cv/softmatch/...``, ``SOFT_STEPS``) and SRPseudoLabel
     (``usb_cv/pseudolabel/...``, ``PL_STEPS``: two forwards and two
     backwards per layer per step, K1 at M 8 x 257 = 2056 rows, K2 at B 8),
     with each algorithm's own state checked (FreeMatch's time_p and
     p_model moved; SoftMatch's mu and var moved, weights in (0, 1];
     PseudoLabel's warm-up factor above 0 and util_ratio finite);
   - classic_cv: WRN-28-2 at the YAMLs' batch 64 + 448 with SGD-nesterov,
     SRFixMatch (``classic_cv/fixmatch/fixmatch_cifar100_10000_0.yaml``)
     and SRPseudoLabel (``classic_cv/pseudolabel/...``), ``WRN_STEPS``
     each, convs and BatchNorm on cuDNN (no Pallas kernel covers this
     path): the BatchNorm running statistics read before and after each
     forward of one step move in the lb / concatenated pass and stay put
     in SRPseudoLabel's unlabeled pass;
   - the USB base algorithms on the ViT-S/2-32 path (K1 and K2), each on
     its ``config/usb_cv/<name>/<name>_cifar100_200_0.yaml`` (8 + 8 images,
     AdamW, layer decay 0.5) for ``USB_STEPS`` steps: PiModel and
     MeanTeacher (MeanTeacher's weak forward counted on the EMA weights),
     VAT (the norm of the r_adv its adversarial forward took and whether
     the power iteration's gradient was zero, every 20th step), MixMatch
     and ReMixMatch (forwards of 8 images:
     K1 at M 2056, K2 at B 8; ReMixMatch's p_model moves, its rotation head
     trains), UDA (at p_cutoff 0), Dash (a 20-step supervised warm-up: rho_init equals the
     eval loss read after it, its steps and eval counted), AdaMatch
     (p_model and p_target move), CRMatch (one forward of 56 images: K1 at
     M 14392, K2 at B 56; at p_cutoff 0 so that its ds and rotation heads
     train) and DeFixMatch (32 images a forward: K1 at M 8224, K2 at B
     32; at p_cutoff 0); the launches of each algorithm's forwards and
     backwards a step (``PASSES``) counted exactly, the warm-up weight of
     the ramped ones above 0, and every mask that the loss reports
     (``util_ratio``, ``util_ratio_lb``) above 0 at some step;
   - CoMatch and SimMatch (``CO_SIM_PHASES``), at ``p_cutoff`` 0 and
     with short epochs (``epoch`` set from ``STEPS_PER_EPOCH``):
     ``vit_comatch`` (one forward of 32 images: K1 at M 8224, K2 at B 32;
     ``queue_batch`` 64: the 1024-row queue's pointer and rows, memory
     smoothing from step 65 counted exactly, the contrastive loss
     non-zero), ``vit_simmatch`` (24
     images; the bank's columns at the labeled indices seen moved, its
     labels those of the last batch, the instance loss 0 in the first
     epoch and above 0 after it), ``vit_simmatch_ema`` (the SimMatch
     STL-10 YAML on a seeded STL-10-layout corpus, ViT-S/2-32 at 96 px:
     N 2305, K1 at M 55320 and the EMA teacher's 18440, whose forwards
     on the EMA weights are counted), ``bert_comatch`` (16 texts a
     forward: K2 at B 16 with the key bias and dropout, K3 at up to M
     8192) and ``audio_simmatch`` (HuBERT-base, 24 clips: K3 at M 4776);
     the queue form of distribution alignment's pointer and rows in each;
   - SemiReward's other modes on the headline config:
     ``vit_srflexmatch_reforward`` (``extra['sr_reforward']`` 8: 1 + 8
     forwards and 2 backwards a layer a stage-2 step, the last
     re-forward's strong logits bit-equal to the base forward's at steps
     20 and 30, the reward filter below 1 in stage 2) and
     ``vit_srflexmatch_per_sample`` (``sr_per_sample``: the rewarder moves
     in stage 1 and stage 2, and scores two samples of one label
     differently);
   - the ten imbalanced-SSL wrappers (``imb/``), each over FixMatch on
     its ``config/classic_cv_imb/fixmatch_<name>/..._cifar10_lb1500_100_
     ulb3000_100_0.yaml`` (``imb_<name>``: WRN-28-2, 64 + 128, SGD, the
     YAML's imbalanced split of synthetic CIFAR-10-shaped images with
     every class holding the head class's 1500 + 3000 rows), and
     ReMixMatch under ABC and under DASO (``imb_remixmatch_abc``,
     ``imb_remixmatch_daso``), ``IMB_STEPS`` steps each, ``IMB_PER_EPOCH``
     steps an epoch (two epoch boundaries), ``p_cutoff`` 0 and the waits
     of ``IMB_OVERRIDES`` cut; each phase checks what its wrapper does
     (``_imb_checks``: SAW's and ADSH's state refit at the first epoch
     end, DebiasPL's ``p_hat``, DARP's ``pseudo_orig`` rows and its
     refinement, DASO's ring pointers against the labeled rows of each
     class, CReST's alignment EMA, the eval head of ABC, TRAS and CoSSL
     at every eval against the step JAX gives, TRAS's term off before its
     epoch, CoSSL's teacher head moved by its warm start and its own SGD),
     the wrappers' heads moved, and which forwards of a step move the
     BatchNorm statistics (``bn_moved_pattern``); no kernel of the port
     runs on the WRN. ``imb_crest_gens``: ``train_crest`` over
     ``CREST_GENS`` generations of ``CREST_GEN_STEPS`` steps, the second
     generation's labeled set larger than the first's. ``vit_abc``: ABC
     over FixMatch on the headline ViT-S/2-32 (its auxiliary head reads
     the features out of K1 and K2); ``vit_srdash``: SemiReward over Dash
     through ``_make_sr_variant`` (Dash's warm-up through the wrapper),
     both with exact K1 / K2 counts;
   - the text and audio forms of MixMatch, ReMixMatch and VAT, the fast
     reverb and DNABERT-2 (``TEXT_AUDIO_PHASES``, ``TEXT_AUDIO_STEPS``
     steps each, K2 + K3, the switches that make the JAX package train
     each form): ``bert_mixmatch_manifold``, ``bert_remixmatch_manifold``
     (``rot_loss_ratio`` 0) and ``bert_vat_embed`` on the usb_nlp aclImdb
     YAMLs (BERT-base, max_length 512, 4 + 4 texts; VAT's r_adv of norm
     ``vat_eps`` a sample on the embeddings); ``audio_mixmatch``,
     ``audio_vat`` (its r_adv and the probe's gradient exactly 0, as in
     JAX, with no probed forward) and ``audio_remixmatch``
     (``rot_loss_ratio`` 0) in input space on the usb_audio ESC-50 YAMLs
     (HuBERT-base, 8 + 8 clips); ``audio_fast_reverb`` (HuBERT FixMatch
     with ``audio_exact_reverb`` False at ``p_cutoff`` 0: the strong views
     took the fast reverb only, which on the card equals the CPU's and
     stays within the bound of the JAX package's test against the exact
     one, ``fast_reverb_checks``); ``dnabert_flexmatch`` (the usb_nlp
     FlexMatch YAML with ``net dnabert_2_117m`` on the seeded CSV k-mer
     corpus under ``build/synth_bio``, 512-token views, ``p_cutoff`` 0);
     the passes a layer a step of each form read off its JAX loss
     (``passes_per_step``);
   - ``jpeg_decode``: the seeded ImageNet-layout JPEG folders of the two
     phases below (``profile_step.synthetic_config`` writes them under
     ``build/``: images of 200-500 px at quality 90, and a grayscale JPEG,
     a CMYK JPEG and a PNG under a ``.JPEG`` name), ``JPEG_CHECK_IMAGES``
     of each decoded on the card (nvJPEG, ``csrc/jpeg_decode.cu``, and the
     resize there) and on the CPU (PIL): the card's batch on the card,
     within ``JPEG_MEAN_BOUND`` / ``JPEG_P99_BOUND`` of the CPU's, exactly
     the CMYK and PNG files redone on the host, the grayscale one three
     equal channels; each route's images/s (``jpeg_phase``);
   - ``vit_b16_remat``: SRFlexMatch on the imagenet_stretch YAML
     (``VITB_YAML``: ViT-B/16 at 224 px, ``gradient_checkpointing``, 256 +
     256 images, ``use_cat``: 768 a forward, AdamW with layer decay 0.75)
     on its seeded JPEG folder of 1000 classes (``VITB_OVERRIDES``),
     decoded on the card at 256 px, the weak views cropped and the strong
     views resized-cropped to 224 from it, the eval center-cropped, through
     K3 (M 151296) and K2 (B 768, N 197, H 12), each checkpointed
     block's K3f and K2f counted once more per backward; then the step's
     gradients with every block checkpointed against the same step
     unchecked, on one batch with the same drop-path masks, bit for bit,
     and peak device memory and steps/s with checkpointing on and off in
     turns (``vitb_remat_checks``);
   - ``resnet50_fixmatch`` and ``resnet50_abc``: ResNet-50 on the
     classic_cv_imb ImageNet-127 YAMLs (``RESNET_YAML``: 112 px, 127
     classes, 256 + 512, SGD) on a split of its seeded JPEG folder
     (decoded on the card at 128 px) at the YAMLs' ratio 286
     (``RESNET_OVERRIDES``): losses finite, the BatchNorm
     statistics moved by the train pass and left by an eval
     (``resnet_checks``), ABC's ``aux_classifier`` moved and its eval head;
     then ``profile_step.py`` on the FixMatch YAML (device busy and idle
     share); no kernel of the port runs on the ResNet;
   - ``dinov2_vitl14_srflexmatch``: DINOv2 ViT-L/14 (C 1024, 24 blocks,
     16 heads, LayerScale 1e-5, gradient checkpointing) on the ViT-B/16
     phase's YAML and JPEG folder, 16 + 16 images with ``use_cat`` (K3 at
     C 1024, M 12336; K2 at B 48, N 257), ``DINO_STEPS`` steps, p_cutoff
     0 (FlexMatch's selection moves), the rewarder moved in both stages,
     one eval and one pair of checkpoint files (~4.9 GB each);
     ``dinov2_vitb14_srpseudolabel_reg``: DINOv2 ViT-B/14 SRPseudoLabel on
     the regression task (the imagenet_stretch PseudoLabel YAML with
     ``dataset agedb``, ``num_classes`` 1, on a seeded AgeDB-layout npz
     under ``build/synth_regression``), 16 + 16 images, three forwards and
     two backwards a step (K3 at C 768, K2 at B 16, N 257): an L1
     ``sup_loss``, ``util_ratio`` 1, ``sr_keep_ratio`` 1 or 0 (one reward
     for every sample, as in the JAX package), the eval's regression keys
     finite and the best checkpoint chosen by -mse
     (``_regression_checks``);
   - ``golden``: the golden-learning checks (``validation.py``) at seed 0
     with the JAX test tier's settings and bounds (``GOLDEN_*``), on the
     card from a CPU generator (``run_golden``'s default: the draws of the
     same run on the CPU, as a JAX key gives every backend one stream):
     FlexMatch's gain over its labeled-only run at 1000 iterations,
     SemiReward under 40% uniform pseudo-label noise at 500, SAW over
     FixMatch at ratio 10 at 400 (its gain printed, not held); it runs
     no kernel of the port and comes after the ``kernels`` line, and a
     failed bound ends the run there, before the ``ok`` line;
   every train phase writes its checkpoints (``latest_model.ckpt``,
   ``model_best.ckpt``) and ``metrics.jsonl`` into a temporary directory,
   prints each checkpoint's bytes and write seconds, and, where the data
   has a test split (BERT, audio), counts the after-run test eval of the
   best checkpoint's weights among its forwards;
5. the run's lifecycle on the headline config, ``vit_resume``: trainer A
   trains ``RESUME_EVAL`` steps (its eval writes the checkpoints, in stage
   2 with a rewarder that has trained); trainer B resumes from a copy of
   A's ``latest_model.ckpt`` as the CLI does (``train.build_trainer``);
   every tensor of B's state equals A's bit for bit on the card, the CUDA
   generator's state included, and ``it``, ``best_metric`` and
   ``best_it`` agree; both then train ``RESUME_MORE`` more steps on the
   same stream (restarted at the seed) and must end bit-equal (the max abs
   difference is printed per group: parameters, EMA, moments, algorithm
   state, SemiReward state); the eval CLI
   (``semireward_tpu_torch.eval.main``) on A's ``model_best.ckpt`` gives
   A's top-1 at ``best_it``; ``metrics.jsonl`` holds the JAX package's
   keys; K1f / K2f launches counted exactly (one forward per eval batch of
   the four evals, the CLI's included);
6. prints one ``kernels`` JSON line, runs the ``golden`` checks and, last,
   prints the ``ok`` JSON line.

Each phase prints its wall seconds on a line of its own as it ends, and
the run its total before the last lines; a JPEG phase prints its decode
(images decoded on the card, files redone on the host, ms and images/s a
step from ``train/prefetch_time``) beside its steps/s. The depth of the
earlier phases was cut so that the smoke with the JPEG, the text and
audio and the DINOv2 phases stays in its time limit (the checks are the
same; PERF.md section 4): the headline ViT 1200 -> 900 -> 700 -> 650
steps, HuBERT 700 -> 600 -> 550 and BERT 600 -> 550 (their first
FlexMatch selection came by steps 600, 500 and 500, with the same
entries, in every H100 run of these phases: 50 steps past it), the text
and audio forms 24 -> 20, USB 40 -> 24, CoMatch 160 -> 80
(``queue_batch`` 128 -> 64), SimMatch 80 -> 40, SimMatch's EMA teacher 40 -> 20, BERT
CoMatch and HuBERT SimMatch 60 -> 30 (their epochs halved with them),
SRFreeMatch / SRSoftMatch / SRPseudoLabel and the two WRN phases 100 ->
50, ``sr_reforward`` 40 -> 32, ``sr_per_sample`` 100 -> 40, the imb
wrappers 80 -> 40 -> 36 steps with 16 (was 32) an epoch and an eval every 12
(was 24), on one data set made once for the twelve, CReST 2 x 20 -> 2 x
12, ``vit_resume`` 40 + 10 -> 30 + 5, ``vit_b16_remat`` 30 -> 22 steps,
the two ResNet-50 phases 40 -> 18 and ResNet-50's profile 10 + 10 -> 2 +
3 steps. The JPEG folders are written on a thread (a
process a core) from the headline phase on, beside the host-bound phases.

Any failed check raises, so the exit code is not 0 and the ``ok`` line is
not printed. Needs one CUDA card; fails without one.
"""
from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE_YAML = os.path.join(
    HERE, "config/SemiReward/usb_cv/flexmatch/flexmatch_cifar100_200_0.yaml")
NLP_YAML = os.path.join(
    HERE, "config/SemiReward/usb_nlp/flexmatch/flexmatch_aclImdb_100_0.yaml")
AUDIO_YAML = os.path.join(
    HERE, "config/SemiReward/usb_audio/flexmatch/flexmatch_esc50_250_0.yaml")
FREE_YAML, SOFT_YAML, PL_YAML = (os.path.join(
    HERE, f"config/SemiReward/usb_cv/{a}/{a}_cifar100_200_0.yaml")
    for a in ("freematch", "softmatch", "pseudolabel"))
# the USB base algorithms, each on its usb_cv ViT-S/2-32 YAML (8 + 8 images,
# AdamW, layer decay 0.5), and the steps each phase trains
USB_ALGOS = ("pimodel", "meanteacher", "vat", "mixmatch", "remixmatch",
             "uda", "dash", "adamatch", "crmatch", "defixmatch")
USB_YAML = {a: os.path.join(HERE, f"config/usb_cv/{a}/{a}_cifar100_200_0.yaml")
            for a in USB_ALGOS}
USB_STEPS, USB_LOG_EVERY = 24, 12
# Dash: a short supervised warm-up (the default is 2048 steps). CRMatch,
# UDA and DeFixMatch: no sample of random weights passes the YAMLs' cutoffs
# (0.95, 0.8, 0.95) in 80 steps (H100 runs: util_ratio 0 in every window of
# UDA and DeFixMatch), which would leave their masked terms (CRMatch's Lu
# and the ds head's Ld, DeFixMatch's debiasing term) without a gradient; at
# 0 every sample passes
USB_OVERRIDES = {"dash": {"num_wu_iter": 20},
                 **{a: {"p_cutoff": 0.0}
                    for a in ("crmatch", "uda", "defixmatch")}}
# CoMatch and SimMatch: (phase, YAML, steps, steps an epoch, overrides). At
# p_cutoff 0 every sample passes the mask; the short epochs (``epoch`` set
# from the YAML's num_train_iter) start CoMatch's memory smoothing after
# step 64 (past the first epoch and ``queue_batch``, cut from 128 to 64: a
# queue of 1024 rows) and SimMatch's instance loss after the first epoch,
# within the phase
CO_SIM_PHASES = (
    ("vit_comatch", "config/usb_cv/comatch/comatch_cifar100_200_0.yaml",
     80, 40, {"queue_batch": 64}),
    ("vit_simmatch", "config/usb_cv/simmatch/simmatch_cifar100_200_0.yaml",
     40, 20, {}),
    # STL-10 is outside _EMA_BANK_DATASETS: the EMA-teacher branch
    ("vit_simmatch_ema", "config/usb_cv/simmatch/simmatch_stl10_40_0.yaml",
     20, 10, {}),
    ("bert_comatch", "config/usb_nlp/comatch/comatch_aclImdb_100_0.yaml",
     30, 10, {}),
    ("audio_simmatch",
     "config/usb_audio/simmatch/simmatch_esc50_250_0.yaml", 30, 10, {}))
# The text and audio forms of MixMatch, ReMixMatch and VAT, the fast reverb
# and DNABERT-2: (phase, YAML, overrides, config extra), each
# TEXT_AUDIO_STEPS steps on BERT-base (usb_nlp aclImdb: max_length 512, 4 + 4
# texts, use_cat; K2 with the key bias and dropout at N 512, K3 at C 768),
# HuBERT-base (usb_audio ESC-50: 4 s at 16 kHz, 8 + 8 clips; K3, K2 at N
# 199) or DNABERT-2 (BERT-base over k-mer ids, 512-token views of the seeded
# CSV corpus: K2 + K3). The switches are the ones that make the JAX package
# train each form (mixup_manifold and vat_embed on token dicts; no rotation
# head off images: its loaders give no rot_v); p_cutoff 0 where a mask
# gates the loss, so that it trains in a short run
TEXT_AUDIO_PHASES = (
    ("bert_mixmatch_manifold", "usb_nlp/mixmatch/mixmatch_aclImdb_100_0",
     {"mixup_manifold": True}, {}),
    ("bert_remixmatch_manifold",
     "usb_nlp/remixmatch/remixmatch_aclImdb_100_0",
     {"mixup_manifold": True, "rot_loss_ratio": 0.0}, {}),
    ("bert_vat_embed", "usb_nlp/vat/vat_aclImdb_100_0", {"vat_embed": True},
     {}),
    ("audio_mixmatch", "usb_audio/mixmatch/mixmatch_esc50_250_0", {}, {}),
    ("audio_vat", "usb_audio/vat/vat_esc50_250_0", {}, {}),
    ("audio_remixmatch", "usb_audio/remixmatch/remixmatch_esc50_250_0",
     {"rot_loss_ratio": 0.0}, {}),
    ("audio_fast_reverb", "usb_audio/fixmatch/fixmatch_esc50_250_0",
     {"p_cutoff": 0.0}, {"audio_exact_reverb": False}),
    ("dnabert_flexmatch", "usb_nlp/flexmatch/flexmatch_aclImdb_100_0",
     {"net": "dnabert_2_117m", "dataset": "synth_dna", "p_cutoff": 0.0}, {}))
TEXT_AUDIO_STEPS, TEXT_AUDIO_LOG_EVERY = 20, 10
# SemiReward's reference-equivalent arm (the JAX bench's 8 re-forwards) and
# per-sample mode, on the headline config
REFORWARD, REFORWARD_STEPS, PER_SAMPLE_STEPS = 8, 32, 40
# the stage-2 steps (ctx.step) whose last re-forward is held bit for bit
# against the base forward
REFORWARD_PROBE = (20, 30)
# the ten imbalanced-SSL wrappers, each over FixMatch on its classic_cv_imb
# CIFAR-10 YAML (WRN-28-2, 64 + 128, SGD; the 1500 / 3000 head-class split
# at ratio 100 on synthetic images), and ReMixMatch under ABC (its RotNet
# inside ABC's head) and under DASO (whose pseudo-label hook ReMixMatch
# never calls). ``epoch`` gives IMB_PER_EPOCH steps an epoch, so the run
# crosses two epoch boundaries; the waits are cut so that each wrapper's
# own path runs inside the phase: DARP refines from epoch 1, TRAS's head
# and CoSSL's teacher switch on at epoch 1 (CoSSL's warm start at that
# boundary; the corpus's cossl_warm_epoch 0 is never reached, the first
# boundary being epoch 1), DASO mixes its prototypes from step 20; ema_m
# 0.9 (the YAMLs' 0.999 leaves the EMA weights, which the epoch-end
# forwards of SAW and ADSH read, at their random init for the whole
# phase: no class-0 prediction, so ADSH's refit is a no-op)
IMB_NAMES = ("saw", "debiaspl", "adsh", "abc", "tras", "darp", "daso",
             "crest", "crest+", "cossl")
IMB_STEPS, IMB_PER_EPOCH, IMB_EVAL_EVERY, IMB_LOG_EVERY = 36, 16, 12, 8
IMB_OVERRIDES = {"darp_warmup_epochs": 0, "tras_warmup_epochs": 1,
                 "daso_num_pretrain_iter": 20, "cossl_warm_epoch": 1,
                 "cossl_tfe_warm_epoch": 1, "ema_m": 0.9}
# CReST's generational driver: two generations of a few steps each
CREST_GENS, CREST_GEN_STEPS = 2, 12
# the wrappers' heads (each must move in training) and eval heads
IMB_HEADS = {"abc": ("aux_classifier",), "tras": ("aux_classifier",),
             "cossl": ("teacher_classifier",)}
USB_FIX_YAML = os.path.join(HERE, "config/usb_cv/fixmatch/"
                            "fixmatch_cifar100_200_0.yaml")


def imb_yaml(base: str, name: str) -> str:
    return os.path.join(HERE, f"config/classic_cv_imb/{base}_{name}/{base}_"
                        f"{name}_cifar10_lb1500_100_ulb3000_100_0.yaml")


# ViT-B/16 at 224 px with gradient checkpointing (SRFlexMatch, 256 + 256,
# use_cat: 768 images a forward, K3 at M 768 * 197 = 151296, K2 at B 768,
# N 197, H 12) on seeded synthetic images of the YAML's 1000 classes. Cut:
# the labels (100,000 -> 2,000) and the images (1.28M JPEGs -> 4,096
# synthetic train and 256 eval images); the YAML's 4-way FSDP mesh runs as
# one card; p_cutoff 0, so that FlexMatch's selected_label moves within the
# short phase. The YAML's (-1, 4) data x fsdp mesh does not fit one card
# (it fails as the JAX package's build_mesh does): the phases set one axis
VITB_YAML = os.path.join(HERE, "config/SemiReward/imagenet_stretch/"
                         "flexmatch/flexmatch_imagenet_100000_0.yaml")
ONE_CARD_MESH = {"mesh_shape": (-1,), "mesh_axes": ("data",)}
VITB_OVERRIDES = {"num_labels": 2000, "synthetic_train": 4096,
                  "p_cutoff": 0.0, **ONE_CARD_MESH}
VITB_STEPS, VITB_AB_STEPS = 22, 4
# DINOv2 (the imagenet_stretch YAMLs with their net swapped; no corpus YAML
# names DINOv2 or a regression set). ``dinov2_vitl14_srflexmatch``:
# ViT-L/14 (C 1024, 24 blocks, 16 heads, H 4096, LayerScale 1e-5, remat as
# the YAML says) on the FlexMatch YAML's seeded JPEG folder (VITB_OVERRIDES:
# 4,096 + 256 images of 1000 classes, decoded at 256 px, cropped to 224: N
# 257), the YAML's 256 + 256 images cut to 16 + 16 with use_cat (48 a
# forward: K3 at C 1024, M 48 * 257 = 12,336; K2 at B 48, N 257);
# ``dinov2_vitb14_srpseudolabel_reg``: ViT-B/14 SRPseudoLabel on the
# regression task (the PseudoLabel YAML with ``dataset agedb``,
# ``num_classes`` 1) over a seeded AgeDB-layout npz (1,024 + 128 images of
# 224 px, ages in [1, 101)), 256 labels, 16 + 16 images (three forwards of
# 16 a step: K3 at C 768, M 4,112; K2 at B 16). One eval each (the YAMLs'
# eval cadence is past the phase), so one pair of checkpoint files: a
# ViT-L/14 file with its EMA and Adam state is ~4.9 GB
DINO_L_OVERRIDES = {**VITB_OVERRIDES, "net": "dinov2_vitl14",
                    "batch_size": 16}
DINO_REG_YAML = os.path.join(HERE, "config/SemiReward/imagenet_stretch/"
                             "pseudolabel/pseudolabel_imagenet_100000_0.yaml")
DINO_REG_OVERRIDES = {"net": "dinov2_vitb14", "dataset": "agedb",
                      "num_classes": 1, "num_labels": 256, "batch_size": 16,
                      "synthetic_train": 1024, "synthetic_test": 128,
                      **ONE_CARD_MESH}
DINO_STEPS, DINO_LOG_EVERY = 24, 12
# K3 at the widths it takes besides 768: (M, C, H, timed). ViT-L/14's train
# shape is timed (the kernels line's C 1024 rows); M 1 and 129 and a
# ragged M at C 512 are checked only
K3_WIDE_SHAPES = ((12336, 1024, 4096, True), (1, 1024, 4096, False),
                  (129, 1024, 4096, False), (2749, 512, 2048, False))
# the phase's steps/s on seeded synthetic arrays, before it read the JPEG
# folders (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
VITB_ARRAY_SPS = "1.93-2.02"
# ResNet-50 on the classic_cv_imb ImageNet-127 YAMLs (112 px, 127 classes,
# 256 + 512, SGD, the split at ratio 286) on seeded synthetic images. Cut:
# the head class's labels (the YAML's 128,101 -> 286, so that the tail
# class keeps 1) and unlabeled rows (the YAML's None, which the imbalanced
# split cannot take -> 572), and the images (1.28M JPEGs -> 16,384, about
# 129 a class: the 18 head classes give every row they hold to the labeled
# set, 5,147 labeled and 3,078 unlabeled rows in all); p_cutoff 0
# (FixMatch's mask at 0.95 stays 0 from random weights in a short run);
# IMB_PER_EPOCH steps an epoch
RESNET_YAML = {a: os.path.join(
    HERE, f"config/classic_cv_imb/{a}/{a}_imagenet127_lb128101_286_ulbNone_"
    f"286_0.yaml") for a in ("fixmatch", "fixmatch_abc")}
RESNET_OVERRIDES = {"num_labels": 286, "ulb_num_labels": 572,
                    "synthetic_train": 16384, "p_cutoff": 0.0,
                    "num_eval_iter": 24}
RESNET_STEPS = 18
# the golden-learning checks at the JAX test tier's settings and bounds
# (tests/test_golden_learning.py): FlexMatch's gain over labeled-only at
# 1000 iterations, SemiReward under 40% uniform noise at 500 (start_timing
# 120), SAW over FixMatch at ratio 10 at 400
GOLDEN_SSL_MARGIN, GOLDEN_SR_SLACK = 0.10, 0.02
GOLDEN_KEEP_RANGE, GOLDEN_SAW_MIN = (0.02, 0.95), 0.85
WRN_FIX_YAML, WRN_PL_YAML = (os.path.join(
    HERE, f"config/SemiReward/classic_cv/{a}/{a}_cifar100_10000_0.yaml")
    for a in ("fixmatch", "pseudolabel"))
# H100 SXM published peaks (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the YAMLs' own schedules and eval cadences stay; a run stops after its
# step count and evaluates there. From random weights (layer decay 0.5
# leaves the early blocks nearly still) the ViT's first weak view passes
# FlexMatch's 0.95 cutoff only after several hundred steps (H100 run: max
# prob 0.93 over 512 unlabeled images at step 400), so the run is long
# enough for selected_label to move (800 steps: 2 entries). BERT-base on the
# synthetic corpus first passes the cutoff between steps 250 and 500 (H100
# run: 11 entries changed at step 500, 686 at step 750). HuBERT-base on the
# synthetic ESC-50 corpus first passed it by step 300 with the unfused
# attention and by step 500 with flash attention (H100 runs: 584 entries
# changed by step 1500, 22 by step 600). BERT and HuBERT ran 700 and 1000
# steps until the ViT-B/16, ResNet-50 and golden phases came. In three H100
# runs since, the first selection came by step 600 (ViT-S) and 500 (BERT,
# HuBERT), the same entries each time: 650, 550 and 550 steps keep 50
# past it (the headline ViT ran 900 until the text and audio phases came,
# 700 until the DINOv2 phases came; BERT and HuBERT 600).
TRAIN_STEPS, START_TIMING, N_K, LOG_EVERY = 650, 10, 10, 100
BERT_STEPS, BERT_LOG_EVERY = 550, 100
AUDIO_STEPS, AUDIO_LOG_EVERY = 550, 100
# the other variants' checks (state moved, the rewarder's two stages, the
# BatchNorm probe, weights at two log boundaries) all fall within these
FREE_STEPS, SOFT_STEPS, PL_STEPS, WRN_STEPS = 50, 50, 50, 50
# the step whose forwards read the BatchNorm statistics before and after
BN_PROBE_STEP = 5
# vit_resume: A's first eval (and checkpoint) at step 30, in stage 2 after
# the rewarder's stage-2 update at step 20; then 5 steps each
RESUME_EVAL, RESUME_MORE = 30, 5
# the JAX package's metrics.jsonl keys beside the step's own train/<k> and
# eval/<k> (core/trainer.py:570-575, 608-609)
LOG_KEYS = {"step", "ts", "lr", "train/steps_per_sec", "train/prefetch_time",
            "train/run_time"}
EVAL_KEYS = {"step", "ts"} | {f"eval/{k}" for k in (
    "top-1-acc", "balanced_acc", "precision", "recall", "F1", "top-5-acc",
    "loss")}


def _num_train_iter(path: str) -> int:
    import yaml

    with open(path) as f:
        return int(yaml.safe_load(f)["num_train_iter"])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def kernel_name(mangled: str) -> str:
    """``ns::kernel<N>`` of a mangled kernel name: the last of its
    length-prefixed nested names and an integer template argument."""
    i, names = mangled.find("N") + 1, []
    while 0 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
    arg = re.match(r"ILi(\d+)E", mangled[i:]) if names else None
    return (names[-1] if names else mangled) + (f"<{arg.group(1)}>" if arg
                                                else "")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check_close(name, got, want, rel_tol, floor=0.0):
    """max|got - want| <= rel_tol * max(max|want|, floor); returns the max
    abs error."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), floor)
    ok = math.isfinite(err) and err <= rel_tol * max(scale, 1e-30)
    print(f"  {name}: max_abs_err={err:.6g} max|plain|={scale:.6g} "
          f"rel={err / max(scale, 1e-30):.3g} tol={rel_tol} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with the plain version")
    return err


def fused_mlp_phase(F):
    """K1 and K3 forward/backward vs the plain version. Tolerances: bf16
    outputs (out, dx, dW) carry 8 significant bits, so one rounding at the
    largest magnitude is 0.4% of it and sums run in another order: 1% of
    max|plain|. Bias grads are f32 sums of the same terms: 0.1%. The
    kernels line takes K1 at the headline shape and K3 at the HuBERT-base
    train shape; K1 at the eval, SRPseudoLabel / MixMatch / ReMixMatch (M
    2056), DeFixMatch and CoMatch (M 32 * 257 = 8224), CRMatch (M 56 * 257
    = 14392), SimMatch on STL-10 (M 24 * 2305 = 55320, its teacher's 18440
    and its eval's 36880) and ViT-Ti shapes and K3 at the BERT-base one
    and CoMatch's on it (M 16 * 512 = 8192) and ViT-B/16's at 224 px (M 768
    * 197 = 151296) are printed beside them. K3 at the widths it takes
    besides 768 (``K3_WIDE_SHAPES``): DINOv2 ViT-L/14's (C 1024, H 4096) at
    M 1, 129 and its train shape 12,336 (timed: the kernels line's
    ``_c1024`` rows) and C 512 at a ragged M."""
    dev = torch.device("cuda")
    results = {}
    shapes = [(m, c, h, m != 100) for m, c, h in (
        (100, 128, 256), (6168, 384, 1536), (4112, 384, 1536),
        (2056, 384, 1536), (8224, 384, 1536), (14392, 384, 1536),
        (55320, 384, 1536), (18440, 384, 1536), (36880, 384, 1536),
        (6168, 192, 768), (100, 768, 3072), (4776, 768, 3072),
        (6144, 768, 3072), (8192, 768, 3072), (151296, 768, 3072))]
    for m, c, h, timed_row in shapes + list(K3_WIDE_SHAPES):
        blocked = F.route(c, h, dev) == "blocked"
        fwd = F.kernel_blocked_fwd if blocked else F.kernel_fwd
        bwd = F.kernel_blocked_bwd if blocked else F.kernel_bwd
        name = "fused_mlp_blocked" if blocked else "fused_mlp"
        g = torch.Generator().manual_seed(0)
        x = torch.randn(m, c, generator=g).to(dev, torch.bfloat16)
        w1 = (torch.randn(h, c, generator=g) * 0.05).to(dev, torch.bfloat16)
        b1 = (torch.randn(h, generator=g) * 0.1).to(dev)
        w2 = (torch.randn(c, h, generator=g) * 0.05).to(dev, torch.bfloat16)
        b2 = (torch.randn(c, generator=g) * 0.1).to(dev)
        gy = torch.randn(m, c, generator=g).to(dev, torch.bfloat16)
        print(f"{name} M={m} C={c} H={h}")
        out = fwd(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err_f = check_close("fwd out", out, F.plain_fwd(x, w1, b1, w2, b2),
                            1e-2)
        grads = bwd(x, w1, b1, w2, gy)
        torch.cuda.synchronize()
        err_b = 0.0
        for n, a, b in zip(("dx", "dw1", "dw2", "db1", "db2"), grads,
                           F.plain_bwd(x, w1, b1, w2, gy)):
            err_b = max(err_b, check_close(
                f"bwd {n}", a, b, 1e-3 if n.startswith("db") else 1e-2))
        again = bwd(x, w1, b1, w2, gy)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"{name} backward is not deterministic")
        print("  backward bit-equal across two launches: ok")
        if not timed_row:
            continue
        # the one-call PyTorch equivalent, timed as a yardstick only
        xl, w1l, b1l, w2l, b2l = (t.detach().clone().requires_grad_()
                                  for t in (x, w1, b1.bfloat16(), w2,
                                            b2.bfloat16()))

        def lib_fwd():
            return torch.addmm(b2l, torch.nn.functional.gelu(
                torch.addmm(b1l, xl, w1l.t())), w2l.t())

        lib_out = lib_fwd()
        fwd_flops = 4.0 * m * c * h
        bwd_flops = 10.0 * m * c * h
        # the forward needs 2 products, the backward 5 (u again, dp = g W2,
        # dx, dW1, dW2); K1's and K3's GEMMs compute exactly these
        bf, byf = bound_ms(nbytes(x, w1, b1, w2, b2, out), fwd_flops)
        bb, byb = bound_ms(nbytes(x, w1, b1, w2, gy, *grads), bwd_flops)
        timed = {
            f"{name}_fwd": dict(
                max_abs_err=err_f,
                ms=time_ms(lambda: fwd(x, w1, b1, w2, b2)),
                plain_ms=time_ms(lambda: F.plain_fwd(x, w1, b1, w2, b2)),
                bound_ms=bf, bound_by=byf,
                library_ms=time_ms(lambda: lib_fwd().detach())),
            f"{name}_bwd": dict(
                max_abs_err=err_b,
                ms=time_ms(lambda: bwd(x, w1, b1, w2, gy)),
                plain_ms=time_ms(lambda: F.plain_bwd(x, w1, b1, w2, gy)),
                bound_ms=bb, bound_by=byb,
                library_ms=time_ms(lambda: torch.autograd.grad(
                    lib_out, (xl, w1l, b1l, w2l, b2l), gy,
                    retain_graph=True)))}
        flops = {f"{name}_fwd": fwd_flops, f"{name}_bwd": bwd_flops}
        for k, r in timed.items():
            print(json.dumps({"kernel": k, "M": m, "C": c, "H": h,
                              "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                              "library_ms": r["library_ms"],
                              "bound_ms": r["bound_ms"],
                              "bound_by": r["bound_by"],
                              "tflops": flops[k] / r["ms"] / 1e9,
                              "share_of_bound": r["bound_ms"] / r["ms"],
                              "max_abs_err": r["max_abs_err"]}))
        print(f"  {'K3' if blocked else 'K1'} plan at M={m}: " + json.dumps(
            {k: v for k, v in F.blocked_plan(
                m, c, h, torch.cuda.get_device_properties(
                    dev).multi_processor_count,
                kernel="blocked" if blocked else "full").items()
             if k not in ("sms", "workspace")}))
        # the kernels line carries K1 at the headline shape, K3 at HuBERT's
        # and at DINOv2 ViT-L/14's train shape
        if (m, c) in ((6168, 384), (4776, 768)):
            results.update(timed)
        if c == 1024:
            results.update({f"{k}_c1024": r for k, r in timed.items()})
    return results


def _attn_inputs(B, N, H, d, padded: bool, seed: int = 0):
    """bf16 q, k, v, dO [B, N, H, d] and, with ``padded``, a BERT padding
    bias [B, 1, 1, N] (-1e9 past each row's length; some rows full)."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, N, H, d, generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    bias = None
    if padded:
        lens = torch.randint(N // 4, N + 1, (B,), generator=g)
        lens[::3] = N
        keep = torch.arange(N)[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :].to(dev)
    return q, k, v, do, bias


def _unfused_attention(q, k, v, bias, rate, generator):
    """The models' attention without K2 (f32 scores of the bf16 values,
    softmax in f32, dropout from torch's stream, probs in bf16 before PV)."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    a = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        a = a + bias
    a = torch.softmax(a, dim=-1)
    if rate:
        keep = torch.rand(a.shape, generator=generator, device=a.device) >= rate
        a = torch.where(keep, a / (1.0 - rate), torch.zeros_like(a))
    return torch.matmul(a.to(v.dtype), v).transpose(1, 2)


def _fwd_bwd_ms(fn, q, k, v, do):
    """One forward and its backward through autograd."""
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    return time_ms(lambda: torch.autograd.grad(fn(ql, kl, vl), (ql, kl, vl),
                                               do), iters=10)


# K2's small ragged shapes (N 1000: the kernels' shared-memory rings wrap);
# the main path's train shapes come from k3_profile.FLASH_SHAPES, and BERT
# also runs without dropout: the difference is the hash's cost
RAGGED_FLASH_SHAPES = (("ragged", (2, 77, 3, True, 0.1)),
                       ("ragged_130", (3, 130, 2, True, 0.1)),
                       ("ragged_1", (2, 1, 3, True, 0.1)),
                       ("ragged_1000", (2, 1000, 3, True, 0.1)))
# shapes held against the plain version but not timed: the ViT-S step of
# SRPseudoLabel, MixMatch and ReMixMatch, whose forwards take 8 images at a
# time, DeFixMatch's and CoMatch's one forward of 32, and SimMatch's on the
# STL-10 YAML at 96 px (N 2305): its forward of 24, its eval's 16 and its
# EMA teacher's 8
CHECK_ONLY_FLASH_SHAPES = (("vit_srpseudolabel", (8, 257, 6, False, 0.0)),
                           ("vit_defixmatch", (32, 257, 6, False, 0.0)),
                           ("vit_stl10_simmatch", (24, 2305, 6, False, 0.0)),
                           ("vit_stl10_eval", (16, 2305, 6, False, 0.0)),
                           ("vit_stl10_teacher", (8, 2305, 6, False, 0.0)))
# timed beside the model shapes: CRMatch's one forward of 56 images,
# CoMatch's of 16 texts on BERT-base and ViT-B/16's of 768 images at 224 px
EXTRA_TIMED_FLASH_SHAPES = (("vit_crmatch", (56, 257, 6, False, 0.0)),
                            ("bert_comatch", (16, 512, 12, True, 0.1)),
                            ("vit_b16_224", (768, 197, 12, False, 0.0)))
HASH_OPS = 19  # integer instructions a score: two lowbias32, counter, compare


def flash_phase(A, model_shapes):
    """K2 forward (out, lse, keep bits) and backward (dq, dk, dv from the
    forward's bits) vs the plain version on the same bf16 inputs. The
    kernels round P, dS and P^T to bf16 before their tensor-core products
    (the JAX kernels keep them in f32): bf16 outputs within 1% of max|plain|
    (one bf16 rounding is 0.4%); lse, an f32 row statistic, within 1e-5 of
    max|plain|; the keep bits exactly pack_keep_bits(attention_keep_mask);
    the backward bit-equal across two launches. Each model shape gets a
    timed row beside F.scaled_dot_product_attention (yardstick only; at the
    ViT shape it computes exactly K2's function, no mask, no dropout)."""
    dev = torch.device("cuda")
    results, versus = {}, {}
    seed = torch.tensor([20240601], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    d = 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    bert = model_shapes["bert"]
    shapes = (RAGGED_FLASH_SHAPES + CHECK_ONLY_FLASH_SHAPES
              + tuple(model_shapes.items()) + EXTRA_TIMED_FLASH_SHAPES
              + (("bert_no_dropout", bert[:4] + (0.0,)),))
    check_only = {n for n, _ in RAGGED_FLASH_SHAPES + CHECK_ONLY_FLASH_SHAPES}
    for name, (B, N, H, padded, rate) in shapes:
        q, k, v, do, bias4 = _attn_inputs(B, N, H, d, padded)
        kb = A._key_bias_of(bias4, B, H, N) if padded else None
        args = (q, k, v, kb, seed, rate)
        print(f"flash_attention {name} B={B} N={N} H={H} d={d} "
              f"bias={padded} dropout={rate}")
        out, lse, bits = A.kernel_fwd(*args, keep_bits=True)
        torch.cuda.synchronize()
        p_out, p_lse = A.plain_fwd(*args)
        err_f = check_close("fwd out", out, p_out, 1e-2)
        check_close("fwd lse", lse, p_lse, 1e-5)
        if rate:
            want = A.pack_keep_bits(A.attention_keep_mask(
                seed, B * H, N, A.padded_len(N), A.keep_threshold(rate)))
            if not torch.equal(bits, want):
                raise AssertionError(f"{int((bits != want).sum())} keep "
                                     f"words differ from pack_keep_bits")
            print(f"  forward's keep bits: {want.numel()} words equal "
                  f"pack_keep_bits(attention_keep_mask): ok")
        grads = A.kernel_bwd(*args, do, lse, out, bits)
        torch.cuda.synchronize()
        # dq and dk sum p * (dp - delta), a difference of two f32 dot
        # products; at N 1 both are exactly 0 in the plain version, so
        # their scale floors at 1e-3 of max|plain dv|
        p_grads = A.plain_bwd(*args, do, lse, A.delta_of(do, out))
        floor = 1e-3 * p_grads[2].float().abs().max().item()
        err_b = 0.0
        for n, a, b in zip(("dq", "dk", "dv"), grads, p_grads):
            err_b = max(err_b, check_close(f"bwd {n}", a, b, 1e-2, floor))
        again = A.kernel_bwd(*args, do, lse, out, bits)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError("flash backward is not deterministic")
        print("  backward bit-equal across two launches: ok")
        if name in check_only:
            continue
        if name in ("vit", "hubert", "bert"):
            versus[name] = dict(
                shape=[B, N, H, d], bias=padded, dropout=rate,
                flash_fwd_bwd_ms=_fwd_bwd_ms(
                    lambda a, b, c: A.flash_attention(
                        a, b, c, bias=bias4, dropout_rate=rate,
                        dropout_seed=seed), q, k, v, do),
                unfused_fwd_bwd_ms=_fwd_bwd_ms(
                    lambda a, b, c: _unfused_attention(a, b, c, bias4, rate,
                                                       gen), q, k, v, do))
            print(f"  flash vs unfused attention (fwd + bwd): "
                  f"{json.dumps(versus[name])}")
        if name == "bert":
            check_dropout_stream(A, B, N, H, d, seed, rate)
            check_backward_masks(A, B, N, H, d, rate)
        # F.scaled_dot_product_attention with the float key mask (BERT) and
        # the same dropout rate (its own RNG stream), timed as a yardstick
        ql, kl, vl = (t.detach().transpose(1, 2).clone().requires_grad_()
                      for t in (q, k, v))
        mask = bias4.to(torch.bfloat16) if padded else None

        def lib_fwd():
            return torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, dropout_p=rate)

        lib_out = lib_fwd()
        do_t = do.transpose(1, 2)
        flops = 2.0 * B * H * N * N * d          # one N x N x d product
        # the function's bytes only: the keep bits the forward writes and
        # the backward reads are this design's, reported beside the bound
        bf, byf = bound_ms(nbytes(q, k, v, kb, seed, out, lse), 2 * flops)
        # the backward needs 5 products (S again, dP, dV, dQ, dK); the
        # kernels' dq / dk-dv split recomputes S and dP once more (7)
        bb, byb = bound_ms(nbytes(q, k, v, kb, seed, do, lse, out, *grads),
                           5 * flops)
        # the hash's integer floor, also outside the bound: HASH_OPS int32
        # instructions a score at 64 lanes a SM a clock, at the max SM clock
        hash_ms = (HASH_OPS * B * H * N * N / (64 * sms * max_hz) * 1e3
                   if rate else 0.0)
        timed = {
            "flash_attention_fwd": dict(
                max_abs_err=err_f,
                ms=time_ms(lambda: A.kernel_fwd(*args, keep_bits=True)),
                plain_ms=time_ms(lambda: A.plain_fwd(*args), iters=5),
                bound_ms=bf, bound_by=byf,
                library_ms=time_ms(lambda: lib_fwd().detach())),
            "flash_attention_bwd": dict(
                max_abs_err=err_b,
                ms=time_ms(lambda: A.kernel_bwd(*args, do, lse, out, bits)),
                plain_ms=time_ms(lambda: A.plain_bwd(
                    *args, do, lse, A.delta_of(do, out)), iters=5),
                bound_ms=bb, bound_by=byb,
                library_ms=time_ms(lambda: torch.autograd.grad(
                    lib_out, (ql, kl, vl), do_t, retain_graph=True)))}
        for k, r in timed.items():
            print(json.dumps({"kernel": k, "shape": name, "B": B, "N": N,
                              "H": H, "bias": padded, "dropout": rate,
                              "kernel_ms": r["ms"],
                              "plain_ms": r["plain_ms"],
                              "library_ms": r["library_ms"],
                              "bound_ms": r["bound_ms"],
                              "bound_by": r["bound_by"],
                              "share_of_bound": r["bound_ms"] / r["ms"],
                              "max_abs_err": r["max_abs_err"],
                              "keep_bits_bytes": nbytes(bits),
                              "hash_floor_ms": (hash_ms if k.endswith("fwd")
                                                else 0.0)}))
        if name == "bert":  # the kernels line carries K2 at the BERT shape
            results.update(timed)
    print(json.dumps({"flash_vs_unfused_attention": versus,
                      "card": card_line()}))
    return results


def check_dropout_stream(A, B, N, H, d, seed, rate):
    """The forward kernel's keep mask, read out exactly: q = k = 0 makes
    every score equal; a key bias of -1e9 outside a window of d keys leaves
    p = 1/d inside it and exactly 0 elsewhere; v one-hot per window key puts
    keep[q, key] / keep_prob / d in output column key - window start. Zero
    against non-zero is exact, so the mask is held bit for bit against
    attention_keep_mask."""
    dev = torch.device("cuda")
    z = torch.zeros(B, N, H, d, device=dev, dtype=torch.bfloat16)
    want = A.attention_keep_mask(seed, B * H, N, A.padded_len(N),
                                 A.keep_threshold(rate))
    got = torch.zeros_like(want)
    keys = torch.arange(N, device=dev)
    for w in range(0, N, d):
        width = min(d, N - w)
        v = torch.zeros_like(z)
        v[:, w:w + width, :, :width] = torch.eye(width, device=dev).to(
            v.dtype)[:, None, :]
        kb = torch.where((keys >= w) & (keys < w + width), 0.0, -1e9)
        out, _, _ = A.kernel_fwd(z, z, v, kb.expand(B * H, N).contiguous(),
                                 seed, rate)
        got[:, :, w:w + width] = (out[..., :width] != 0).permute(
            0, 2, 1, 3).reshape(B * H, N, width)
    diff = int((got != want).sum())
    print(f"  dropout stream at BH={B * H} N={N}: {diff} of {want.numel()} "
          f"keep bits differ, keep share {want.float().mean().item():.5f} "
          f"{'ok' if diff == 0 else 'FAIL'}")
    if diff:
        raise AssertionError("the kernel's dropout stream differs from "
                             "attention_keep_mask")


def check_backward_masks(A, B, N, H, d, rate):
    """The dq and dk/dv kernels' keep masks, read out exactly from bits
    packed by the plain pack_keep_bits: lse = 0 and q.k = 0 make every p =
    1, out = 0 makes delta = 0. dq: K one-hot over a window of d keys, V =
    dO = e0, so dq[q, c] is keep[q, w + c] * scale / keep_prob. dv: K = V =
    0, dO one-hot over a window of d queries, so dv[key, c] is keep[w + c,
    key] / keep_prob. Held bit for bit against attention_keep_mask."""
    dev = torch.device("cuda")
    seed = torch.tensor([424242], dtype=torch.int32, device=dev)
    keep = A.attention_keep_mask(seed, B * H, N, A.padded_len(N),
                                 A.keep_threshold(rate))
    bits = A.pack_keep_bits(keep)
    z = torch.zeros(B, N, H, d, device=dev, dtype=torch.bfloat16)
    lse = torch.zeros(B * H, N, device=dev)
    e0 = z.clone()
    e0[..., 0] = 1
    for which in ("dq", "dv"):
        got = torch.zeros_like(keep)
        for w in range(0, N, d):
            width = min(d, N - w)
            one_hot = z.clone()
            one_hot[:, w:w + width, :, :width] = torch.eye(
                width, device=dev).to(z)[:, None, :]
            if which == "dq":
                g, _, _ = A.kernel_bwd(z, one_hot, e0, None, seed, rate, e0,
                                       lse, z, bits)
                got[:, :, w:w + width] = (g[..., :width] != 0).permute(
                    0, 2, 1, 3).reshape(B * H, N, width)
            else:
                _, _, g = A.kernel_bwd(z, z, z, None, seed, rate, one_hot,
                                       lse, z, bits)
                got[:, w:w + width, :] = (g[..., :width] != 0).permute(
                    0, 2, 3, 1).reshape(B * H, width, N)
        diff = int((got != keep).sum())
        print(f"  {which} kernel's dropout mask at BH={B * H} N={N}: {diff} "
              f"of {keep.numel()} keep bits differ "
              f"{'ok' if diff == 0 else 'FAIL'}")
        if diff:
            raise AssertionError(f"the {which} kernel's dropout mask differs "
                                 f"from attention_keep_mask")


# (forwards, backwards) per train step of every layer, read off each
# algorithm's loss (the JAX package's, which the port's follows forward for
# forward): a forward without gradient counts as a forward only
PASSES = {
    # labeled; unlabeled weak (BN frozen)
    "pseudolabel": (2, 2),
    # labeled; weak (no gradient; MeanTeacher's on the EMA weights);
    # second weak
    "pimodel": (3, 2), "meanteacher": (3, 2),
    # labeled; unlabeled; the probe (its autograd.grad is a backward; on
    # token dicts with vat_embed through the embeddings); adversarial. On
    # the audio nets the probe's gradient is JAX's exact 0 (the frozen
    # extractor), taken without the probe's forward: ``passes_per_step``
    "vat": (4, 4),
    # two weak (no gradient); three mixed chunks of num_lb rows (the JAX
    # loss's labeled forward, whose outputs no loss reads, is not run;
    # mixup_manifold: ``passes_per_step``)
    "mixmatch": (5, 3),
    # weak (no gradient); s0 (the u1 loss); four mixed chunks; the rotated
    # s0 view (the JAX loss's labeled and s1 forwards, whose outputs no
    # loss reads, are not run; rot_loss_ratio 0 and mixup_manifold:
    # ``passes_per_step``)
    "remixmatch": (7, 6),
    # one forward over [lb, w, s, rot x 4]
    "crmatch": (1, 1),
    # one forward over [lb, w, s0, s1] / [lb, w, s], whatever use_cat says
    # (SimMatch's EMA teacher adds one: ``launch_passes``)
    "comatch": (1, 1), "simmatch": (1, 1),
}


def passes_per_step(base: str, cfg):
    """(forwards, backwards) per train step of every layer (``PASSES``); the
    algorithms on ``ssl_forward`` forward the concatenated views once with
    ``use_cat`` (DeFixMatch's labeled part holds both labeled views), else
    three times with the weak pass under no_grad. Read off each JAX loss:

    ================================= ======== =========
    algorithm                         forwards backwards
    ================================= ======== =========
    ssl_forward, ``use_cat``          1        1
    ssl_forward, separate passes      3        2
    pseudolabel                       2        2
    pseudolabel, regression           3        2
    pimodel, meanteacher              3        2
    vat (images; text, ``vat_embed``) 4        4
    vat (waveforms: no probe)         3        3
    mixmatch                          5        3
    mixmatch, ``mixup_manifold``      3        1
    remixmatch                        7        6
    remixmatch, ``rot_loss_ratio`` 0  6        5
    remixmatch, ``mixup_manifold``    5 (4)    4 (3)
    crmatch, comatch                  1        1
    simmatch                          1 (+1)   1
    SemiReward, ``sr_reforward`` n    1 (1+n)  1 (2)
    ================================= ======== =========

    PseudoLabel's regression form: the labeled, the noisy unlabeled and
    the clean unlabeled forward (no gradient; its logits are the pseudo
    label).
    MixMatch's manifold form: the two weak forwards without gradient and
    the labeled one; its mixed chunks go through the head alone.
    ReMixMatch's: the weak (no gradient), labeled, s0 and s1 forwards, the
    rotated view's where the rotation head is on (in brackets: off);
    its chunks through the head alone.

    In brackets: SimMatch with its EMA teacher (a dataset outside
    ``_EMA_BANK_DATASETS``; the teacher's forward has no backward) and
    SemiReward's stage-2 steps with ``extra['sr_reforward']`` n > 1 (n - 1
    re-forwards without gradient and the last one with it, whose backward
    runs beside the base forward's); ``launch_passes`` adds them up."""
    from semireward_tpu_torch.data.modality import modality_of

    if base == "vat" and modality_of(cfg.net) == "audio":
        return 3, 3
    if base == "pseudolabel" and cfg.is_regression:
        return 3, 2
    if base == "mixmatch" and cfg.mixup_manifold:
        return 3, 1
    if base == "remixmatch":
        rot = int(cfg.rot_loss_ratio > 0)
        return (4 + rot, 3 + rot) if cfg.mixup_manifold else (6 + rot,
                                                               5 + rot)
    if base in PASSES:
        return PASSES[base]
    return (1, 1) if cfg.use_cat else (3, 2)


def launch_passes(cfg, alg, base: str, steps: int):
    """(forwards, backwards) of every layer over ``steps`` train steps from
    step 0: ``passes_per_step`` a step, plus SimMatch's EMA-teacher forward
    a step, plus ``sr_reforward`` n > 1's n forwards and one backward a
    stage-2 step (``ctx.step > start_timing``)."""
    n_fwd, n_bwd = passes_per_step(base, cfg)
    fwd, bwd = n_fwd * steps, n_bwd * steps
    if getattr(alg, "use_ema_teacher", False):
        fwd += steps
    n_ref = (int(cfg.extra.get("sr_reforward", 1))
             if getattr(alg, "HAS_SR", False) else 1)
    if n_ref > 1:
        stage2 = max(0, steps - (cfg.start_timing + 1))
        fwd, bwd = fwd + n_ref * stage2, bwd + stage2
    return fwd, bwd


def _algo_tensors(base: str, algo):
    """The algorithm state the phase checks (each must move), cloned."""
    if base == "flexmatch":
        return {"selected_label": algo.selected_label.clone()}
    if base == "freematch":
        return {"time_p": algo.time_p.clone(), "p_model": algo.p_model.clone()}
    if base == "softmatch":
        return {"mu": algo.gaussian.prob_max_mu_t.clone(),
                "var": algo.gaussian.prob_max_var_t.clone()}
    if base == "adamatch":  # both EMAs move (update_target)
        return {"p_model": algo.p_model.clone(),
                "p_target": algo.p_target.clone()}
    if base == "remixmatch":  # p_target stays the labeled class shares
        return {"p_model": algo.p_model.clone()}
    if base == "dash":  # rho_init from the warm-up's eval, rho at step 0
        return {"rho": algo.rho.clone()}
    if base == "comatch":
        return {"queue_feats": algo.queue_feats.clone(),
                "da_p_model": algo.dist_align.p_model.clone()}
    if base == "simmatch":
        return {"mem_bank": algo.mem_bank.clone(),
                "da_p_model": algo.dist_align.p_model.clone()}
    return {}


# the heads of the algorithm's wrapper; each must move in training
HEADS = {"remixmatch": ("rot_classifier",),
         "crmatch": ("ds_classifier", "rot_classifier")}
# the algorithms whose unsupervised loss ramps up with unsup_warm_up
RAMPED = ("pseudolabel", "pimodel", "meanteacher", "vat", "mixmatch",
          "remixmatch")


def _bn_probe(model, record):
    """Wrap ``model.forward`` so that each call records whether the last
    BatchNorm's running mean moved in it; returns the undo."""
    from semireward_tpu_torch.models.batchnorm import BatchNorm

    bn = [m for m in model.modules() if isinstance(m, BatchNorm)][-1]
    orig = model.forward

    def forward(*a, **kw):
        before = bn.running_mean.clone()
        out = orig(*a, **kw)
        record.append(not torch.equal(before, bn.running_mean))
        return out

    model.forward = forward
    return lambda: model.__dict__.pop("forward")


def _spies(trainer, base):
    """Wrap the module functions the phase reads: MeanTeacher's and
    SimMatch's EMA forward (each call must get the state's EMA list),
    VAT's perturbation (every 20th power-iteration gradient and the r_adv
    that the adversarial forward took), CoMatch's memory smoothing (its
    calls) and SemiReward's re-forwards (the last one's strong logits at
    ``REFORWARD_PROBE``); returns the records and the undo."""
    from semireward_tpu_torch.algorithms import comatch, pimodel, vat

    rec, undo = {"ema_forwards": 0, "grad_d": [], "r_adv": [],
                 "smoothing": 0, "reforward_s": {}}, []
    if base in ("meanteacher", "simmatch"):
        orig_ema = pimodel.ema_forward

        def ema_forward(model, ema, x, generator=None, **kw):
            assert ema is trainer.state.ema, "the teacher is not the EMA"
            rec["ema_forwards"] += 1
            return orig_ema(model, ema, x, generator, **kw)

        pimodel.ema_forward = ema_forward
        undo.append(lambda: setattr(pimodel, "ema_forward", orig_ema))
    if base == "vat":
        orig_perturb = vat.adversarial_perturbation
        calls = [0]

        def adversarial_perturbation(*a):
            r_adv, g = orig_perturb(*a)
            calls[0] += 1
            if calls[0] % 20 == 1:
                rec["grad_d"].append(g.clone())
                rec["r_adv"].append(r_adv.clone())
            return r_adv, g

        vat.adversarial_perturbation = adversarial_perturbation
        undo.append(lambda: setattr(vat, "adversarial_perturbation",
                                    orig_perturb))
    if base == "comatch":
        orig_smooth = comatch.memory_smoothing

        def memory_smoothing(*a):
            rec["smoothing"] += 1
            return orig_smooth(*a)

        comatch.memory_smoothing = memory_smoothing
        undo.append(lambda: setattr(comatch, "memory_smoothing",
                                    orig_smooth))
    if hasattr(trainer.alg, "_reforwards"):
        orig_ref = trainer.alg._reforwards

        def reforwards(ctx, *a):
            st, mask, f = orig_ref(ctx, *a)
            if ctx.step in REFORWARD_PROBE:
                rec["reforward_s"][ctx.step] = f.logits_x_ulb_s.detach(
                    ).clone()
            return st, mask, f

        trainer.alg._reforwards = reforwards
        undo.append(lambda: trainer.alg.__dict__.pop("_reforwards"))
    return rec, lambda: [u() for u in undo]


def bn_moved_pattern(cfg, alg, base: str, n_fwd: int):
    """Which forwards of one step move the BatchNorm running statistics,
    in order: the lb (or concatenated) pass; PseudoLabel's unlabeled pass
    does not; ReMixMatch's first mixed chunk alone does (the weak, labeled
    with ``keep_fwd``, s0, the other chunks and the rotated view run
    frozen); an imb wrapper's EMA forwards before the step (DASO's labeled
    features, CoSSL's two TFE streams) run in eval mode and do not."""
    if base == "pseudolabel":
        pattern = [True, False]
    elif base == "remixmatch":
        chunks = (cfg.batch_size + 3 * cfg.ulb_batch_size) // cfg.batch_size
        pattern = ([False] * (1 + bool(alg.base.keep_fwd) + 1) + [True]
                   + [False] * (chunks - 1) + [False] * bool(
                       cfg.rot_loss_ratio > 0))
    else:
        pattern = [True] * n_fwd
    pre = {"daso": 1, "cossl": 2}.get(getattr(alg, "NAME", ""), 0)
    return [False] * pre + pattern


def kernel_layers(module, F):
    """(fused MLP layers by the path their width takes, K1 ``full``, K3
    ``blocked`` or the two dense layers ``dense``; flash attention layers)
    inside ``module``."""
    fused = {"full": 0, "blocked": 0, "dense": 0}
    for m in module.modules():
        if getattr(m, "use_fused", False):
            fc1 = next(c for c in m.children()
                       if isinstance(c, torch.nn.Linear)
                       and c.out_features > c.in_features)
            fused[F.route(fc1.in_features, fc1.out_features, "cuda")] += 1
    n_flash = sum(bool(getattr(m, "use_flash", False))
                  for m in module.modules()
                  if not getattr(m, "attn_drop", 0.0))
    return fused, n_flash


# each phase's wall seconds, printed as it ends; the total at the end
PHASE_SECONDS = {}


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds printed on a line of their own
    and kept in ``PHASE_SECONDS[name]``."""
    t0 = time.time()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = time.time() - t0
    print(f"phase {name}: {PHASE_SECONDS[name]:.1f} s", flush=True)
    return out


def train_phase(name, *args, **kw):
    return timed(name, _train_phase, name, *args, **kw)


def jpeg_stats(trainer, save_dir):
    """A JPEG-folder phase's decode: the counts (images nvJPEG decoded on
    the card, files redone on the host) and, from ``metrics.jsonl``, the
    host's wait for each step's raw batch (``train/prefetch_time``, here
    the labeled and unlabeled batches' read, decode and resize: no
    producer thread), as ms and images/s a step."""
    decoded, redone = trainer.jpeg_counts()
    cfg = trainer.cfg
    with open(os.path.join(save_dir, cfg.save_name, "metrics.jsonl")) as f:
        wait = [json.loads(line)["train/prefetch_time"] for line in f
                if "train/prefetch_time" in line]
    per_step = cfg.batch_size + cfg.ulb_batch_size
    ms = 1e3 * sum(wait[1:]) / max(len(wait) - 1, 1)  # after the first
    return {"decoded_on_card": decoded,
            "redone_on_host": sorted(os.path.basename(p) for p in redone),
            "decode_size": trainer.bundle.train_lb.img_size,
            "images_a_step": per_step,
            "prefetch_time_s_by_window": wait,
            "decode_ms_a_step": ms,
            "decode_images_per_s": per_step / (ms / 1e3) if ms else None}


def _train_phase(name, yaml_path, overrides, steps, log_every, F, A,
                 main_kernels, cfg_extra=None, after=None, bundle=None):
    """Train ``steps`` steps through ``Trainer.train`` with every count set
    to 0 just before and read just after; checks the launch counts exactly
    (the forwards and backwards of every layer on a kernel,
    ``launch_passes``; one forward per eval batch; Dash's warm-up steps
    and eval; under gradient checkpointing each checkpointed block's
    forward once more per backward), that the path's kernels launched,
    losses, the SemiReward
    reward filter and rewarder updates in both stages (and the
    ``sr_reforward`` and ``sr_per_sample`` modes' own checks), the
    algorithm's own state (CoMatch's queue, SimMatch's bank, their
    distribution-alignment rings), its wrapper's heads, the BatchNorm
    running statistics where the net has them, and the eval. ``cfg_extra``
    goes into the config's ``extra`` (``sr_reforward``: the JAX loss reads
    it there). ``after(trainer)`` runs the phase's own checks on the
    trained run after the counts are read, and returns what it read.
    ``bundle``: the data, where phases share it (else the config's)."""
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.data.modality import modality_of
    from semireward_tpu_torch.imb.base import ImbAlgorithm
    from semireward_tpu_torch.models.batchnorm import BatchNorm
    from semireward_tpu_torch.profile_step import synthetic_config

    save_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    cfg = synthetic_config(yaml_path, {"num_log_iter": log_every,
                                       "start_timing": START_TIMING,
                                       "N_k": N_K, "save_dir": save_dir,
                                       **overrides})
    cfg.extra.update(cfg_extra or {})
    trainer = Trainer(cfg, bundle=bundle)
    model = trainer.model
    sr = getattr(trainer.alg, "HAS_SR", False)
    imb = trainer.alg.NAME if isinstance(trainer.alg, ImbAlgorithm) else None
    base = (trainer.alg.base if sr or imb else trainer.alg).NAME
    n_fwd, n_bwd = passes_per_step(base, cfg)
    if getattr(trainer.alg.base if imb else trainer.alg, "keep_fwd", False):
        n_fwd, n_bwd = n_fwd + 1, n_bwd + 1  # ReMixMatch's labeled forward
    n_ref = int(cfg.extra.get("sr_reforward", 1)) if sr else 1
    teacher = getattr(trainer.alg, "use_ema_teacher", False)
    n_wu = (int(cfg.extra.get("num_wu_iter", cfg.num_wu_iter))
            if trainer.needs_warmup else 0)
    fused, n_flash = kernel_layers(model, F)
    # the kernel layers inside checkpointed blocks: their forward runs
    # again in each backward
    remat_fused, remat_flash = {"full": 0, "blocked": 0, "dense": 0}, 0
    for m in model.modules():
        if getattr(m, "remat", False):
            f, n = kernel_layers(m, F)
            remat_fused = {k: remat_fused[k] + f[k] for k in f}
            remat_flash += n
    has_bn = any(isinstance(m, BatchNorm) for m in model.modules())
    print(f"train {name}: {cfg.algorithm} {cfg.net} {type(model).__name__} "
          f"batch={cfg.batch_size}+{cfg.ulb_batch_size} use_cat={cfg.use_cat} "
          f"steps={steps} warm-up steps={n_wu} forwards/backwards a "
          f"step={n_fwd}/{n_bwd} (EMA teacher {teacher}, sr_reforward "
          f"{n_ref}) fused MLP layers K1={fused['full']} "
          f"K3={fused['blocked']} flash layers={n_flash} BatchNorm={has_bn} "
          f"checkpointed K1/K3/flash layers {remat_fused['full']}/"
          f"{remat_fused['blocked']}/{remat_flash}")
    def base_state():
        return trainer.state.algo[0] if imb else trainer.state.algo

    state0 = _algo_tensors(base, base_state())
    heads = HEADS.get(base, ()) + IMB_HEADS.get(imb, ())
    heads0 = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.split(".")[-2:-1] and n.split(".")[-2] in heads}
    imb_rec = {"snaps": {}, "y_lb": [], "idx_ulb": [], "eval_keys": []}
    history, rewarder_snaps, first_select, bn_moved = [], {}, [], []
    last, evals = {}, []
    loss_fn = trainer.alg.loss

    seen_idx, base_s = [], {}

    def loss_spy(ctx):
        out = loss_fn(ctx)
        last["mask"], last["unsup_weight"] = out.mask, out.unsup_weight
        if imb:
            imb_rec["y_lb"].append(ctx.batch["y_lb"])
            imb_rec["idx_ulb"].append(ctx.batch["idx_ulb"])
        if base == "simmatch":
            seen_idx.append(ctx.batch["idx_lb"])
            last["idx_lb"], last["y_lb"] = ctx.batch["idx_lb"], \
                ctx.batch["y_lb"]
        if cfg.sr_per_sample:
            last["feats_w"] = out.fwd.feats_x_ulb_w.detach()
            last["pl"] = out.pseudo_label.detach()
        if n_ref > 1 and ctx.step in REFORWARD_PROBE:
            base_s[ctx.step] = out.fwd.logits_x_ulb_s.detach().clone()
        return out

    trainer.alg.loss = loss_spy
    evaluate = trainer.evaluate

    def eval_spy(*a, **kw):
        m = evaluate(*a, **kw)
        evals.append(m)
        return m

    trainer.evaluate = eval_spy
    logits_fn = trainer._logits

    def logits_spy(x, weights=None, out_key="logits"):
        imb_rec["eval_keys"].append((trainer.state.step, out_key))
        return logits_fn(x, weights, out_key)

    trainer._logits = logits_spy
    if imb == "adsh":
        # the logits each refit reads, and s before and after it
        from semireward_tpu_torch.imb import adsh as adsh_mod
        orig_refit = adsh_mod.refit_thresholds
        imb_rec["refits"] = []

        def refit_spy(logits, s, tau_1):
            new = orig_refit(logits, s, tau_1)
            imb_rec["refits"].append((logits, s.copy(),
                                      new.astype(np.float32)))
            return new

        adsh_mod.refit_thresholds = refit_spy
        undo_refit = [lambda: setattr(adsh_mod, "refit_thresholds",
                                      orig_refit)]
    else:
        undo_refit = []
    spied, unspy = _spies(trainer, base)
    weights_range, undo = [], []

    def step_hook(step, metrics):
        history.append((step, metrics))
        # ctx.step = step - 1; the rewarder trains in stage 1 at ctx.step 5
        # and in stage 2 at ctx.step 20
        if sr and step in (5, 6, 20, 21):
            rewarder_snaps[step] = [p.detach().clone() for p in
                                    trainer.state.sr.rewarder.parameters()]
        if has_bn and step == BN_PROBE_STEP - 1:
            undo.append(_bn_probe(model, bn_moved))
        if has_bn and step == BN_PROBE_STEP:
            undo.pop()()
        # the wrapper's state at the first epoch boundary: before its hook
        # (step_hook runs before it) and one step after
        if imb and step in (IMB_PER_EPOCH - 1, IMB_PER_EPOCH,
                            IMB_PER_EPOCH + 1):
            imb_rec["snaps"][step] = _imb_tensors(trainer)
        # read at the log boundaries, where the trainer syncs anyway
        if step % log_every == 0:
            if base == "softmatch":
                w = last["mask"]
                weights_range.append((float(w.min()), float(w.max())))
            if (base == "flexmatch" and not first_select and bool(
                    (trainer.state.algo.selected_label
                     != state0["selected_label"]).any())):
                first_select.append(step)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    F.reset_launches()
    A.reset_launches()
    try:
        results = trainer.train(num_iters=steps, step_hook=step_hook)
    finally:
        unspy()
        for u in undo_refit:
            u()
    torch.cuda.synchronize()
    launches = {**F.launches, **A.launches}
    peak_bytes = torch.cuda.max_memory_allocated()

    n_eval = math.ceil(len(trainer.bundle.eval) / cfg.eval_batch_size)
    # the after-run eval of the best checkpoint on the test split
    test = getattr(trainer.bundle, "test", None)
    n_test = (math.ceil(len(test) / cfg.eval_batch_size)
              if test is not None else 0)
    assert (n_test > 0) == any(k.startswith("test/") for k in results)
    # Dash: its warm-up steps (labeled forward and backward) and the eval
    # that sets rho_init
    fwd_steps, bwd_steps = launch_passes(cfg, trainer.alg, base, steps)
    fwd_calls = fwd_steps + n_eval + n_test + (n_wu + n_eval) * bool(n_wu)
    bwd_calls = bwd_steps + n_wu
    want = {"fused_mlp_fwd": (fused["full"] * fwd_calls
                              + remat_fused["full"] * bwd_calls),
            "fused_mlp_bwd": fused["full"] * bwd_calls,
            "fused_mlp_blocked_fwd": (fused["blocked"] * fwd_calls
                                      + remat_fused["blocked"] * bwd_calls),
            "fused_mlp_blocked_bwd": fused["blocked"] * bwd_calls,
            "flash_attention_fwd": (n_flash * fwd_calls
                                    + remat_flash * bwd_calls),
            "flash_attention_bwd": n_flash * bwd_calls,
            # no MLP of a smoke path takes the two dense layers
            "fused_mlp_dense": 0}
    assert fused["dense"] == 0, fused
    print(f"  launches {launches} (expected {want})")
    assert launches == want, (launches, want)
    for k in main_kernels:
        assert launches[k] > 0, f"{k} never launched on the {name} path"
    assert len(history) == steps, (len(history), steps)
    for step, m in history:
        for k, v in m.items():
            # max_reward is -inf until the rewarder first scores
            assert math.isfinite(float(v)) or k == "max_reward", (step, k, v)
        if sr:
            keep = float(m["sr_keep_ratio"])
            if cfg.is_regression and step - 1 > START_TIMING:
                # the one-column pseudo label gives every sample pseudo
                # class 0, so one reward: ``reward >= mean`` keeps all of
                # them, or none where the float32 mean of the equal rewards
                # rounds up (the JAX package's arithmetic; ROADMAP §3)
                assert keep in (0.0, 1.0), (step, keep)
            elif step - 1 > START_TIMING:
                assert 0.0 < keep <= 1.0, (step, keep)
            else:
                assert keep == 1.0, (step, keep)
        if cfg.is_regression:
            assert float(m["util_ratio"]) == 1.0, (step, m["util_ratio"])
    if sr:
        for a, b, stage in ((5, 6, 1), (20, 21, 2)):
            assert any(not torch.equal(p, q) for p, q in
                       zip(rewarder_snaps[a], rewarder_snaps[b])), \
                f"the stage-{stage} rewarder update did not move the rewarder"
    # a masked term that no sample passes gives no gradient, and a wrong
    # value of it would pass unseen
    masks = {k: max(float(m[k]) for _, m in history)
             for k in ("util_ratio", "util_ratio_lb") if k in history[0][1]}
    if not sr:
        assert all(v > 0.0 for v in masks.values()), masks
    state = _algo_tensors(base, base_state())
    moved = {k: int((state[k] != v).sum()) for k, v in state0.items()}
    for k, n in moved.items():
        assert n > 0, f"{base}'s {k} never moved"
    extra = {"state_entries_moved": moved, "max_util_ratio": masks}
    if heads0:
        heads = {n: float((p.detach() - heads0[n]).abs().max())
                 for n, p in model.named_parameters() if n in heads0}
        assert all(v > 0 for v in heads.values()), heads
        extra["head_max_abs_move"] = heads
    if base == "flexmatch":
        extra["first_selected_at_step"] = (first_select or [None])[0]
    if base == "softmatch":
        assert weights_range and all(0.0 < lo <= hi <= 1.0
                                     for lo, hi in weights_range), \
            weights_range
        extra["weights_min_max"] = weights_range
    if base in RAMPED:
        assert last["unsup_weight"] > 0.0, last["unsup_weight"]
        extra["unsup_warmup_weight"] = last["unsup_weight"]
    if n_wu:
        # the warm-up's eval comes first; its loss is rho_init (float32)
        rho_init = float(trainer.state.algo.rho_init)
        assert rho_init == float(torch.tensor(evals[0]["loss"])), (
            rho_init, evals[0]["loss"])
        extra.update(warmup_steps=n_wu, rho_init=rho_init,
                     rho=float(trainer.state.algo.rho),
                     lr_log_offset=trainer._lr_log_offset)
        assert trainer._lr_log_offset == n_wu
        assert trainer.state.opt.count == n_wu + steps
    if base == "meanteacher":
        assert spied["ema_forwards"] == steps, spied
        extra["ema_teacher_forwards"] = spied["ema_forwards"]
    if base == "simmatch":
        assert spied["ema_forwards"] == (steps if teacher else 0), spied
        extra["ema_teacher_forwards"] = spied["ema_forwards"]
    if base in ("comatch", "simmatch"):
        extra.update(_co_sim_checks(trainer, cfg, base, steps, history,
                                    state0, seen_idx, last, spied))
    if n_ref > 1:
        got = spied["reforward_s"]
        assert sorted(got) == sorted(base_s) == list(REFORWARD_PROBE), (
            sorted(got), sorted(base_s))
        for t in REFORWARD_PROBE:
            assert torch.equal(got[t], base_s[t]), (
                f"the last re-forward's strong logits differ from the base "
                f"forward's at step {t}")
        keep = [float(m["sr_keep_ratio"]) for step, m in history
                if step - 1 > START_TIMING]
        assert min(keep) < 1.0, keep
        extra.update(reforwards=n_ref, stage2_keep_min=min(keep),
                     last_reforward_bit_equal_at=list(REFORWARD_PROBE))
    if cfg.sr_per_sample:
        # the last batch's weak features, all scored with the first one's
        # pseudo-label: the per-sample rewarder tells them apart
        feats = last["feats_w"]
        pl = last["pl"].argmax(-1) if last["pl"].is_floating_point() \
            else last["pl"]
        with torch.no_grad():
            r = trainer.state.sr.rewarder(feats, pl[:1].expand(len(pl)))
        spread = float(r.max() - r.min())
        assert spread > 0.0, "two samples of one label took one reward"
        extra["reward_spread_one_label"] = spread
    if base == "vat":
        # on the audio nets JAX's gradient is exactly 0 and so is r_adv;
        # elsewhere every sample's r_adv has norm vat_eps
        eps = 0.0 if modality_of(cfg.net) == "audio" else cfg.vat_eps
        r_adv = [r.flatten(1).norm(dim=1) for r in spied["r_adv"]]
        zero = [bool((g == 0).all()) for g in spied["grad_d"]]
        extra.update(r_adv_norm_min_max=[(float(r.min()), float(r.max()))
                                         for r in r_adv],
                     grad_d_all_zero=zero,
                     grad_d_abs_max=[float(g.abs().max())
                                     for g in spied["grad_d"]])
        assert spied["grad_d"] and all(zero) == (eps == 0.0) and (
            any(zero) == (eps == 0.0)), zero
        assert all(abs(float(r.min()) - eps) <= 1e-3 * eps
                   and abs(float(r.max()) - eps) <= 1e-3 * eps
                   for r in r_adv), r_adv
    if imb:
        extra.update(_imb_checks(trainer, cfg, imb, steps, history,
                                 imb_rec))
    if has_bn:
        want_bn = bn_moved_pattern(cfg, trainer.alg, base, n_fwd)
        assert bn_moved == want_bn, (bn_moved, want_bn)
        extra["bn_stats_moved_by_forward"] = bn_moved
    for k, v in results.items():
        assert math.isfinite(v), (k, v)
    if cfg.is_regression:
        extra.update(_regression_checks(trainer, evals, results, save_dir))
        if sr:
            extra["stage2_keep_ratios"] = sorted({
                float(m["sr_keep_ratio"]) for step, m in history
                if step - 1 > START_TIMING})
    if after is not None:
        extra.update(after(trainer))
    windows = trainer.log_history[1:]  # after the first (warm-up) window
    sps = sum(w["steps"] for w in windows) / sum(w["seconds"] for w in windows)
    if trainer.jpeg_counts() is not None:
        extra["jpeg"] = jpeg_stats(trainer, save_dir)
        print(f"  {name} on the JPEG folder: {sps:.3f} steps/s, decode "
              f"{extra['jpeg']['decode_ms_a_step']:.1f} ms a step "
              f"({extra['jpeg']['decode_images_per_s']:.0f} images/s)"
              + (f"; on synthetic arrays: {VITB_ARRAY_SPS} steps/s"
                 if name == "vit_b16_remat" else ""))
    score = "mse" if cfg.is_regression else "top-1-acc"
    print(f"  losses finite over {len(history)} steps; "
          + ("" if not sr else "stage-2 keep ratio 0 or 1; "
             if cfg.is_regression else "stage-2 keep ratio in (0, 1]; ")
          + f"{base} state moved {moved}; eval {score} "
          f"{results[f'eval/{score}']:.4f}; peak device memory "
          f"{peak_bytes / 1e9:.2f} GB")
    writes = _checkpoint_writes(trainer)
    print(json.dumps({"phase": name, "algorithm": cfg.algorithm,
                      "net": cfg.net, "train_steps_per_sec": sps,
                      "measured_steps": sum(w["steps"] for w in windows),
                      "forwards_backwards_per_step": [n_fwd, n_bwd],
                      "forwards_backwards_in_all": [fwd_steps, bwd_steps],
                      **extra, "eval_top1": results.get("eval/top-1-acc"),
                      "test_top1": results.get("test/top-1-acc"),
                      "peak_device_bytes": peak_bytes,
                      "checkpoint_writes": writes,
                      "card": card_line(), "log": trainer.log_history}))
    del trainer, model
    shutil.rmtree(save_dir)
    torch.cuda.empty_cache()
    return launches


def _regression_checks(trainer, evals, results, save_dir):
    """A regression run's eval: the keys of ``regression_metrics``, finite,
    no classification key, and the best checkpoint chosen by -mse (the
    trainer's tracking and ``model_best.ckpt``'s record)."""
    from semireward_tpu_torch.core.checkpoint import read_payload

    keys = {"mse", "rmse", "mae", "mape", "r2"}
    assert evals and all(set(m) == keys for m in evals), evals
    assert all(math.isfinite(v) for m in evals for v in m.values()), evals
    assert "eval/top-1-acc" not in results, sorted(results)
    best = max(range(len(evals)), key=lambda i: -evals[i]["mse"])
    assert trainer.best_metric == -evals[best]["mse"], (trainer.best_metric,
                                                         evals)
    payload = read_payload(os.path.join(save_dir, trainer.cfg.save_name,
                                        "model_best.ckpt"))
    assert payload["extra"]["best_metric"] == trainer.best_metric, \
        payload["extra"]
    return {"eval_regression": evals[-1],
            "best_by_neg_mse": trainer.best_metric}


def _co_sim_checks(trainer, cfg, base, steps, history, state0, seen_idx,
                   last, spied):
    """CoMatch's queue and SimMatch's bank after ``steps`` steps from the
    start, and their distribution-alignment rings: pointers where the step
    count puts them, the rows written, CoMatch's smoothing calls and
    contrastive loss, SimMatch's bank columns and labels and its instance
    loss by epoch. Returns what it read."""
    st = trainer.state.algo
    da = st.dist_align
    L = da.p_model.shape[0]
    rows = int((da.p_model.sum(1) > 0).sum())
    assert int(da.p_model_ptr) == steps % L and rows == min(steps, L), (
        int(da.p_model_ptr), rows)
    out = {"dist_align_ptr": int(da.p_model_ptr),
           "dist_align_rows_written": rows}
    per_epoch = max(cfg.num_train_iter // max(cfg.epoch, 1), 1)
    if base == "comatch":
        size = trainer.alg.queue_size
        n_ins = cfg.batch_size + cfg.ulb_batch_size
        written = int((st.queue_feats.abs().sum(1) > 0).sum())
        assert int(st.queue_ptr) == (steps * n_ins) % size, int(st.queue_ptr)
        assert written == min(steps * n_ins, size), written
        contrast = [float(m["contrast_loss"]) for _, m in history]
        assert all(c != 0.0 for c in contrast), contrast
        want = sum(1 for t in range(steps)
                   if t // per_epoch > 0 and t > cfg.queue_batch)
        assert spied["smoothing"] == want, (spied["smoothing"], want)
        if steps > cfg.queue_batch + per_epoch:
            assert want > 0
        out.update(queue_size=size, queue_ptr=int(st.queue_ptr),
                   queue_rows_written=written, smoothing_steps=want,
                   contrast_loss_min_max=[min(contrast), max(contrast)])
    else:
        seen = torch.unique(torch.cat(seen_idx))
        moved = (st.mem_bank[:, seen] != state0["mem_bank"][:, seen]).any(0)
        assert bool(moved.all()), int((~moved).sum())
        idx, y = last["idx_lb"], last["y_lb"]
        alone = (idx[:, None] == idx[None, :]).sum(1) == 1
        assert torch.equal(st.labels_bank[idx[alone]], y[alone].long())
        # history's step is ctx.step + 1
        first = [float(m["in_loss"]) for t, m in history if t <= per_epoch]
        after = [float(m["in_loss"]) for t, m in history if t > per_epoch]
        assert all(v == 0.0 for v in first) and after and min(after) > 0, (
            first, after)
        out.update(bank_columns=int(st.mem_bank.shape[1]),
                   bank_columns_seen_moved=int(seen.numel()),
                   in_loss_after_first_epoch_min=min(after))
    return out


def _imb_tensors(trainer):
    """The wrapper's state (``algo.1.*``) and its heads, cloned."""
    from semireward_tpu_torch.core.train_state import _flatten

    out = {}
    _flatten("algo", trainer.state.algo[1], out)
    out = {k: v.detach().clone() for k, v in out.items()}
    for n, p in trainer.model.named_parameters():
        if n.split(".")[-2:-1] and n.split(".")[-2] in (
                "aux_classifier", "teacher_classifier"):
            out[n] = p.detach().clone()
    return out


def _imb_checks(trainer, cfg, name, steps, history, rec):
    """What each imbalanced-SSL wrapper does, read off the run (``history``'s
    step is ctx.step + 1; the first epoch boundary's hook runs after the
    step ``IMB_PER_EPOCH``): SAW's and ADSH's state refit at the boundary,
    DebiasPL's ``p_hat`` moved, DARP's ``pseudo_orig`` rows written and the
    refinement run, DASO's ring pointers advanced by the labeled rows of
    each class, CReST's alignment EMA moved, the eval head of ABC, TRAS and
    CoSSL by step, TRAS's and CoSSL's terms off before their epoch and on
    after, CoSSL's teacher head moved by its warm start and by its own
    SGD. Returns what it read."""
    alg, st = trainer.alg, trainer.state.algo[1]
    snaps = rec["snaps"]
    e = IMB_PER_EPOCH
    before, after = snaps[e], snaps[e + 1]
    changed = sorted(k for k in before if not torch.equal(before[k],
                                                          after[k]))
    out = {"imb": name, "changed_at_first_epoch_end": changed}
    metric = {"abc": "abc_loss", "tras": "tras_loss", "daso": "assign_loss",
              "cossl": "tea_loss"}.get(name)
    if metric:
        vals = [float(m[metric]) for _, m in history]
        out[f"{metric}_min_max"] = [min(vals), max(vals)]
    if name == "saw":
        assert "algo.x_ulb_weights" in changed, changed
    if name == "adsh":
        # each refit against the rule on the logits it read; s moves where
        # class 0 (the head class) is among the predictions
        from semireward_tpu_torch.imb.adsh import refit_thresholds
        assert rec["refits"], "ADSH never refit"
        for logits, s0, s1 in rec["refits"]:
            want = refit_thresholds(logits, s0, alg.tau_1).astype(np.float32)
            assert np.array_equal(s1, want), (s1, want)
        class0 = [int((lg.argmax(-1) == 0).sum()) for lg, _, _ in
                  rec["refits"]]
        assert max(class0) > 0, class0
        assert all(not np.array_equal(a, b) for (_, a, b), c in
                   zip(rec["refits"], class0) if c), rec["refits"]
        out.update(adsh_s=st["adsh_s"].tolist(), refits=len(class0),
                   class0_predictions_at_refits=class0)
    if name == "debiaspl":
        uniform = torch.full_like(st["p_hat"], 1.0 / cfg.num_classes)
        assert not torch.equal(st["p_hat"], uniform)
        out["p_hat"] = st["p_hat"].tolist()
    if name == "darp":
        seen = torch.unique(torch.cat(rec["idx_ulb"]))
        u = 1.0 / cfg.num_classes
        written = (st.pseudo_orig[seen] != u).any(1)
        assert bool(written.all()), int((~written).sum())
        refined = bool((st.pseudo_refine != u).any())
        assert refined, "DARP never refined past its warm-up"
        out.update(pseudo_orig_rows_written=int(seen.numel()),
                   pseudo_refined=refined)
    if name == "daso":
        y = torch.cat(rec["y_lb"]).long()
        total = torch.bincount(y, minlength=cfg.num_classes)
        L = st.bank.shape[1]
        assert torch.equal(st.bank_ptr.long(), total % L), (
            st.bank_ptr.tolist(), total.tolist())
        assert torch.equal(st.bank_cnt.long(), total.clamp(max=L))
        vals = [float(m["assign_loss"]) for _, m in history]
        assert min(vals) > 0, vals
        out.update(bank_ptr=st.bank_ptr.tolist(),
                   labeled_rows_by_class=total.tolist())
    if name in ("crest", "crest+"):
        assert bool(st.initialized) and bool((st.p_model > 0).all())
        out["p_model"] = st.p_model.tolist()
    keys = rec["eval_keys"]
    want = {"abc": lambda t: "logits_aux",
            "tras": lambda t: ("logits" if t // e < alg.warmup_epochs
                               else "logits_aux"),
            "cossl": lambda t: ("logits_tfe" if t // e >= alg.warm_epoch
                                else "logits")}.get(name, lambda t: "logits")
    assert keys and all(k == want(t) for t, k in keys), keys
    if name in ("tras", "cossl"):
        assert len({k for _, k in keys}) == 2, keys  # evals on both sides
        switch = e * (alg.warmup_epochs if name == "tras" else alg.warm_epoch)
        term = [float(m[metric]) for t, m in history]
        if name == "tras":  # the term is 0 until its epoch
            assert all(v == 0.0 for v in term[:switch]), term[:switch]
            assert min(term[switch:]) > 0, term[switch:]
        mom = "algo.tfe_momentum.kernel"
        if name == "cossl":
            head = [k for k in before if k.endswith("teacher_classifier"
                                                    ".weight")][0]
            assert head in changed, changed  # the warm start
            assert not bool(before[mom].any()) and bool(after[mom].any())
            assert bool(st["tfe_momentum"]["kernel"].any())
        out.update(eval_head_switch_step=switch,
                   eval_keys=sorted(set(keys)))
    return out


def crest_phase(F, A):
    """CReST's generational driver (``imb.crest.train_crest``) over
    FixMatch on its classic_cv_imb CIFAR-10 YAML: ``CREST_GENS``
    generations of ``CREST_GEN_STEPS`` steps, each from scratch; the second
    generation's labeled set holds the first's plus pseudo-labeled rows.
    No kernel runs on the WRN (counts read and returned)."""
    from semireward_tpu_torch.imb.crest import train_crest
    from semireward_tpu_torch.profile_step import synthetic_config

    save_dir = tempfile.mkdtemp(prefix="chip_smoke_crest_")
    cfg = synthetic_config(imb_yaml("fixmatch", "crest+"), {
        "num_log_iter": 6, "save_dir": save_dir,
        "num_eval_iter": CREST_GEN_STEPS, "crest_num_gens": CREST_GENS})
    sizes = []
    F.reset_launches()
    A.reset_launches()
    t0 = time.time()
    best, trainer = train_crest(
        cfg, num_iters=CREST_GEN_STEPS,
        on_generation=lambda gen, tr: sizes.append(
            (len(tr.bundle.train_lb), tr.alg.cur_dist_align_t)))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {**F.launches, **A.launches}
    assert all(v == 0 for v in launches.values()), launches
    assert len(sizes) == CREST_GENS and sizes[1][0] > sizes[0][0], sizes
    assert sizes[0][1] == 1.0 and sizes[1][1] == 0.5, sizes
    for gen, results in best.items():
        assert all(math.isfinite(v) for v in results.values()), (gen, results)
    print(json.dumps({"phase": "imb_crest_gens", "algorithm": "fixmatch",
                      "imb_algorithm": "crest+", "net": cfg.net,
                      "generations": CREST_GENS, "steps_each": CREST_GEN_STEPS,
                      "labeled_rows_and_dist_align_t_by_generation": sizes,
                      "eval_top1_by_generation": {
                          g: r["eval/top-1-acc"] for g, r in best.items()},
                      "seconds": seconds, "card": card_line()}))
    del trainer
    shutil.rmtree(save_dir)
    torch.cuda.empty_cache()
    return launches


def _remat_grads(trainer, batch, g0, remat: bool):
    """The gradients of the train step's loss at the trainer's state on
    ``batch``, every ViT block checkpointed or not, the generator at
    ``g0`` (the same drop-path masks either way); convs in cuDNN's
    deterministic algorithms."""
    from semireward_tpu_torch.algorithms.base import StepCtx

    st, model = trainer.state, trainer.model
    for blk in model.blocks:
        blk.remat = remat
    trainer.generator.set_state(g0)
    ctx = StepCtx(model=model, batch=batch, algo_state=st.algo,
                  generator=trainer.generator, step=st.step, sr_state=st.sr,
                  ema=st.ema)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False):
        out = trainer.alg.loss(ctx)
        grads = torch.autograd.grad(out.total_loss,
                                    list(model.parameters()),
                                    allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    return grads


def vitb_remat_checks(trainer):
    """On the trained ViT-B/16 run: the step's gradients with every block
    checkpointed against the same step unchecked, on one batch with the
    same drop-path masks (bit for bit: every kernel on the path gives the
    same bits every launch); then peak device memory and steps/s of the
    train step with checkpointing on and off, in turns (on, off, off, on),
    ``VITB_AB_STEPS`` steps each."""
    loader = trainer._make_loader(seed=trainer.cfg.seed + 7)
    batch = trainer.make_batch(next(loader))
    g0 = trainer.generator.get_state()
    on = _remat_grads(trainer, batch, g0, True)
    off = _remat_grads(trainer, batch, g0, False)
    differ = [n for (n, _), a, b in zip(trainer.model.named_parameters(),
                                         on, off) if not torch.equal(a, b)]
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(on, off))
    print(json.dumps({"vit_b16_remat_grads": {
        "leaves": len(on), "leaves_that_differ": differ[:20],
        "max_abs_diff": worst, "tolerance": 0.0,
        "grad_abs_max": max(float(g.abs().max()) for g in on)}}))
    assert not differ, f"remat on / off gradients differ in {differ[:20]}"
    del on, off
    ab = {True: [], False: []}
    for remat in (True, False, False, True):
        for blk in trainer.model.blocks:
            blk.remat = remat
        raws = [next(loader) for _ in range(VITB_AB_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for raw in raws:
            trainer._step(trainer.state, trainer.make_batch(raw),
                          trainer.generator)
        torch.cuda.synchronize()
        ab[remat].append({"steps_per_sec": VITB_AB_STEPS
                          / (time.perf_counter() - t0),
                          "peak_bytes": torch.cuda.max_memory_allocated()})
    for blk in trainer.model.blocks:
        blk.remat = True
    out = {"remat_on": ab[True], "remat_off": ab[False],
           "grads_bit_equal": True}
    print(json.dumps({"vit_b16_remat_ab": out, "card": card_line()}))
    return out


def resnet_checks(trainer):
    """An eval leaves every BatchNorm's running statistics where the train
    steps put them."""
    from semireward_tpu_torch.models.batchnorm import BatchNorm

    bns = [m for m in trainer.model.modules() if isinstance(m, BatchNorm)]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    trainer.evaluate()
    torch.cuda.synchronize()
    assert all(torch.equal(m.running_mean, a) and torch.equal(m.running_var, b)
               for m, (a, b) in zip(bns, before)), "an eval moved BatchNorm"
    return {"batchnorms": len(bns), "eval_left_bn_stats": True}


def golden_phase(F, A):
    """The golden-learning checks on the card at seed 0 from a CPU
    generator (``validation.run_golden``), at the JAX test tier's settings,
    held to its bounds (``GOLDEN_*``): FlexMatch beats its labeled-only
    run by ``GOLDEN_SSL_MARGIN``; SemiReward under 40% uniform
    pseudo-label noise loses at most ``GOLDEN_SR_SLACK`` against the noisy
    FlexMatch, its count-weighted keep rate inside ``GOLDEN_KEEP_RANGE``;
    SAW over FixMatch reaches a balanced accuracy above ``GOLDEN_SAW_MIN``
    (its gain over FixMatch is printed, not held). The WRN runs no kernel
    of the port (counts read and returned)."""
    from semireward_tpu_torch import validation as V

    save_dir = tempfile.mkdtemp(prefix="chip_smoke_golden_")
    F.reset_launches()
    A.reset_launches()
    t0 = time.time()
    ssl = V.ssl_gain("flexmatch", iters=1000, save_dir=save_dir)
    sr = V.sr_noise_experiment(noise_frac=0.4, iters=500, start_timing=120,
                               save_dir=save_dir)
    saw = V.imb_gain("saw", gamma=10.0, iters=400, save_dir=save_dir)
    torch.cuda.synchronize()
    launches = {**F.launches, **A.launches}
    rates, counts = sr["per_label_keep_rate"], sr["per_label_count"]
    keep = sum(r * c for r, c in zip(rates, counts)) / max(sum(counts), 1)
    checks = {
        "ssl": ssl["ssl_acc"] >= ssl["supervised_acc"] + GOLDEN_SSL_MARGIN,
        "sr": (sr["sr_noisy_flexmatch_acc"]
               >= sr["noisy_flexmatch_acc"] - GOLDEN_SR_SLACK),
        "keep": GOLDEN_KEEP_RANGE[0] < keep < GOLDEN_KEEP_RANGE[1],
        "saw": saw["imb_balanced_acc"] > GOLDEN_SAW_MIN}
    print(json.dumps({"phase": "golden", "seed": 0, "rng_device": "cpu",
                      "ssl_gain": ssl,
                      "sr_noise": {k: sr[k] for k in (
                          "noisy_flexmatch_acc", "sr_noisy_flexmatch_acc",
                          "sr_gain", "per_label_keep_rate",
                          "per_label_count")},
                      "keep_rate_count_weighted": keep, "imb_saw": saw,
                      "checks": checks, "seconds": time.time() - t0,
                      "card": card_line()}, default=float))
    assert all(v == 0 for v in launches.values()), launches
    assert all(checks.values()), checks
    shutil.rmtree(save_dir)
    return launches


def resnet_profile():
    """``profile_step.py`` on the ResNet-50 FixMatch YAML at the phase's
    cuts: device busy and idle share of the step."""
    from semireward_tpu_torch import profile_step

    sets = [f"{k}={v}" for k, v in RESNET_OVERRIDES.items()]
    r = profile_step.main(["--config", RESNET_YAML["fixmatch"], "--warmup",
                           "2", "--steps", "3"]
                          + [a for kv in sets for a in ("--set", kv)])
    assert r["device_busy_ms_per_step"] > 0, r


def _checkpoint_writes(trainer):
    """Each checkpoint file the trainer wrote: name, bytes, seconds."""
    return [{"file": os.path.basename(w["path"]), "bytes": w["bytes"],
             "seconds": w["seconds"]} for w in trainer.ckpt_writes]


def _diff_by_group(sa, sb):
    """Max abs difference of two state dicts by group of leaves, and the
    leaves that differ."""
    groups = {"parameters and buffers": "model.", "EMA": "ema.",
              "moments and counts": "opt.", "algorithm state": "algo",
              "SemiReward state": "sr.", "step and generator": ("step", "rng")}
    out, differ = {}, []
    for group, prefix in groups.items():
        worst = 0.0
        for k in sa:
            if not k.startswith(prefix):
                continue
            a, b = sa[k], sb[k]
            if not torch.equal(a, b):
                differ.append(k)
                worst = max(worst, (a.double() - b.double()).abs().max()
                            .item() if a.is_floating_point() else math.inf)
        out[group] = worst
    return out, differ


def resume_phase(F, A):
    """Checkpoint, resume, continue and the eval CLI on the headline config
    (section 5 of the module docstring); returns the phase's launches."""
    from semireward_tpu_torch import eval as port_eval
    from semireward_tpu_torch.core.checkpoint import BEST, LATEST
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.profile_step import synthetic_config
    from semireward_tpu_torch.train import build_trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")

    def config(run, **kw):
        return synthetic_config(HEADLINE_YAML, {
            "num_log_iter": 5, "num_eval_iter": RESUME_EVAL,
            "start_timing": START_TIMING, "N_k": N_K,
            "save_dir": os.path.join(root, run), **kw})

    F.reset_launches()
    A.reset_launches()
    a = Trainer(config("a"))
    cfg = a.cfg
    top1 = {}
    a.train(num_iters=RESUME_EVAL,
            eval_hook=lambda step, m: top1.__setitem__(step, m["top-1-acc"]))
    run_dir = os.path.join(root, "a", cfg.save_name)
    copy = os.path.join(root, "resume_from.ckpt")
    shutil.copy(os.path.join(run_dir, LATEST), copy)
    writes = _checkpoint_writes(a)
    b = build_trainer(config("b", resume=True, load_path=copy))
    sa, sb = a.state.state_dict(), b.state.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].device == sb[k].device and sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), f"leaf {k} differs after the load"
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert (b.state.step, b.best_metric, b.best_it) == (
        a.state.step, a.best_metric, a.best_it) and b.state.step == RESUME_EVAL
    print(f"vit_resume: {len(sa)} leaves bit-equal after the load on "
          f"{a.device} (the {a.generator.device} generator's state "
          f"included); it {b.state.step}, best "
          f"{b.best_metric:.4f} @ {b.best_it}")
    more = RESUME_EVAL + RESUME_MORE
    a.train(num_iters=more,
            eval_hook=lambda step, m: top1.__setitem__(step, m["top-1-acc"]))
    b.train(num_iters=more)
    torch.cuda.synchronize()
    diffs, differ = _diff_by_group(a.state.state_dict(), b.state.state_dict())
    # tolerance: 0 (every op of the step gives the same bits every launch)
    print(json.dumps({"vit_resume_continued_steps": RESUME_MORE,
                      "max_abs_diff_by_group": diffs,
                      "leaves_that_differ": differ[:20], "tolerance": 0.0}))
    assert not differ, f"the continued steps differ in {differ[:20]}"
    best = os.path.join(run_dir, BEST)
    m = port_eval.main(["--load_path", best, "--dataset", cfg.dataset,
                        "--net", cfg.net, "--num_classes",
                        str(cfg.num_classes), "--img_size", str(cfg.img_size),
                        "--crop_ratio", str(cfg.crop_ratio), "--batch_size",
                        str(cfg.eval_batch_size)])
    torch.cuda.synchronize()
    launches = {**F.launches, **A.launches}
    assert m["top-1-acc"] == top1[a.best_it], (m, top1, a.best_it)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = {f"train/{k}" for k in ("sup_loss", "unsup_loss", "total_loss",
                                      "util_ratio", "sr_keep_ratio")}
    for line in lines:
        keys = set(line)
        if "eval/top-1-acc" in line:
            assert keys == EVAL_KEYS, keys ^ EVAL_KEYS
        else:
            assert LOG_KEYS | losses <= keys, (LOG_KEYS | losses) - keys
            assert all(k.startswith("train/") for k in keys - LOG_KEYS), keys
    n_eval = math.ceil(len(a.bundle.eval) / cfg.eval_batch_size)
    steps = more + RESUME_MORE  # A's 35 and B's 5
    fwd_calls, bwd_calls = steps + 4 * n_eval, steps  # A 2 evals, B, CLI
    n_mlp = sum(bool(getattr(m, "use_fused", False))
                for m in a.model.modules())
    n_flash = sum(bool(getattr(m, "use_flash", False))
                  for m in a.model.modules())
    want = {"fused_mlp_fwd": n_mlp * fwd_calls,
            "fused_mlp_bwd": n_mlp * bwd_calls,
            "fused_mlp_blocked_fwd": 0, "fused_mlp_blocked_bwd": 0,
            "flash_attention_fwd": n_flash * fwd_calls,
            "flash_attention_bwd": n_flash * bwd_calls,
            "fused_mlp_dense": 0}
    print(f"  launches {launches} (expected {want})")
    assert launches == want, (launches, want)
    print(json.dumps({"phase": "vit_resume", "algorithm": cfg.algorithm,
                      "net": cfg.net, "evals_top1": top1,
                      "best_it": a.best_it, "eval_cli_top1": m["top-1-acc"],
                      "metrics_jsonl_lines": len(lines),
                      "checkpoint_writes": writes, "card": card_line()}))
    del a, b
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return launches


# jpeg_decode: images of each seeded folder held on the card route against
# the CPU route, and the bound the JAX package holds its own native decoder
# to against PIL (tests/test_modalities.py:323): mean |diff| < 4 levels,
# 99th percentile <= 16
JPEG_CHECK_IMAGES, JPEG_MEAN_BOUND, JPEG_P99_BOUND = 256, 4.0, 16.0
# the files of a seeded folder that nvJPEG must reject (the grayscale JPEG
# is its own: three equal channels)
JPEG_REDONE = ["planted_cmyk.JPEG", "planted_png.JPEG"]


def write_jpeg_folders():
    """Start writing the seeded JPEG folders of the ViT-B/16 and ResNet-50
    phases (``profile_step.synthetic_config``: a process a core) on a
    thread, so that the writing runs beside the host-bound phases before
    them. Returns the thread and a list that takes its error;
    ``jpeg_phase`` joins it."""
    from semireward_tpu_torch.profile_step import synthetic_config

    errors = []

    def run():
        try:
            for path, over in ((VITB_YAML, VITB_OVERRIDES),
                               (RESNET_YAML["fixmatch"], RESNET_OVERRIDES)):
                synthetic_config(path, over)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    thread = threading.Thread(target=run, name="jpeg-folders")
    thread.start()
    return thread, errors


def jpeg_phase(folders):
    """nvJPEG on the card against PIL on the CPU, on ``JPEG_CHECK_IMAGES``
    train images of each seeded folder (the ViT-B/16 YAML's at 256 px, the
    ResNet-50 one's at 128; the three planted files among them): the card's
    batch lies on the card, differs from the CPU's by under the bound,
    nvJPEG rejected exactly the CMYK and PNG files (decoded on the host)
    and gave the grayscale one three equal channels. Prints each route's
    images/s (warm: the second gather of the same files). ``folders``:
    ``write_jpeg_folders``'s thread and error list, joined first."""
    from semireward_tpu_torch.data.cv_extra import get_imagenet
    from semireward_tpu_torch.profile_step import synthetic_config

    thread, errors = folders
    thread.join()
    if errors:
        raise errors[0]
    out = {}
    for yaml_path, over in ((VITB_YAML, VITB_OVERRIDES),
                            (RESNET_YAML["fixmatch"], RESNET_OVERRIDES)):
        cfg = synthetic_config(yaml_path, over)
        size = int(math.floor(cfg.img_size / cfg.crop_ratio))
        card, _ = get_imagenet(cfg.data_dir, size, "cuda")
        host, _ = get_imagenet(cfg.data_dir, size, "cpu")
        names = [os.path.basename(p) for p in card.paths]
        planted = [names.index(n) for n in sorted(
            JPEG_REDONE + ["planted_gray.JPEG"])]
        rs = np.random.RandomState(0)
        rest = rs.choice(np.setdiff1d(np.arange(len(card)), planted),
                         JPEG_CHECK_IMAGES - len(planted), replace=False)
        idx = np.concatenate([planted, rest])
        secs = {}
        for route, ds in (("card", card), ("cpu", host)):
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = ds.gather(idx)
                torch.cuda.synchronize()
                secs[route] = time.perf_counter() - t0
            if route == "card":
                got = batch
        assert got.is_cuda and got.dtype == torch.uint8, got.device
        assert tuple(got.shape) == (len(idx), size, size, 3), got.shape
        diff = np.abs(got.cpu().numpy().astype(np.int16) - batch)
        gray = got[1]  # idx starts with the planted cmyk, gray, png
        redone = sorted(os.path.basename(p) for p in card.redone_on_host)
        res = {"folder": cfg.data_dir, "decode_size": size,
               "images": len(idx), "mean_abs_diff": float(diff.mean()),
               "p99_abs_diff": float(np.percentile(diff, 99)),
               "max_abs_diff": int(diff.max()),
               "bound": [JPEG_MEAN_BOUND, JPEG_P99_BOUND],
               "redone_on_host": redone,
               "decoded_on_card": card.decoded_on_card,
               "gray_three_equal_channels": bool(
                   torch.equal(gray[..., 0], gray[..., 1])
                   and torch.equal(gray[..., 1], gray[..., 2])),
               "card_images_per_s": len(idx) / secs["card"],
               "cpu_images_per_s": len(idx) / secs["cpu"],
               "cpu_threads": os.cpu_count(),
               "nvjpeg_version": card._nvjpeg.version(), "card": card_line()}
        print(json.dumps({"jpeg_decode": res}), flush=True)
        assert res["mean_abs_diff"] < JPEG_MEAN_BOUND, res
        assert res["p99_abs_diff"] <= JPEG_P99_BOUND, res
        assert redone == JPEG_REDONE, redone
        assert card.decoded_on_card == 2 * (len(idx) - len(JPEG_REDONE))
        assert res["gray_three_equal_channels"], res
        out[size] = res
    return out


def new_phases(F, A):
    """ViT-B/16 at 224 px with gradient checkpointing (K2 + K3), ResNet-50
    FixMatch and FixMatch + ABC on the ImageNet-127 YAMLs, each on its
    seeded JPEG folder decoded on the card; returns each phase's
    launches."""
    k3 = ("fused_mlp_blocked_fwd", "fused_mlp_blocked_bwd")
    k2 = ("flash_attention_fwd", "flash_attention_bwd")
    out = [train_phase("vit_b16_remat", VITB_YAML, VITB_OVERRIDES,
                       VITB_STEPS, 11, F, A, k2 + k3,
                       after=vitb_remat_checks)]
    per_epoch = {"epoch": _num_train_iter(RESNET_YAML["fixmatch"])
                 // IMB_PER_EPOCH}
    for name, key in (("resnet50_fixmatch", "fixmatch"),
                      ("resnet50_abc", "fixmatch_abc")):
        out.append(train_phase(name, RESNET_YAML[key],
                               {**RESNET_OVERRIDES, **per_epoch},
                               RESNET_STEPS, 9, F, A, (),
                               after=resnet_checks))
    timed("resnet50_profile", resnet_profile)
    return out


def dinov2_phases(F, A):
    """DINOv2 ViT-L/14 SRFlexMatch on the ViT-B/16 phase's JPEG folder (K2
    + K3 at C 1024) and DINOv2 ViT-B/14 SRPseudoLabel on the seeded AgeDB
    npz (K2 + K3 at C 768); returns each phase's launches."""
    k23 = ("flash_attention_fwd", "flash_attention_bwd",
           "fused_mlp_blocked_fwd", "fused_mlp_blocked_bwd")
    return [train_phase("dinov2_vitl14_srflexmatch", VITB_YAML,
                        DINO_L_OVERRIDES, DINO_STEPS, DINO_LOG_EVERY, F, A,
                        k23),
            train_phase("dinov2_vitb14_srpseudolabel_reg", DINO_REG_YAML,
                        DINO_REG_OVERRIDES, DINO_STEPS, DINO_LOG_EVERY, F, A,
                        k23)]


# K4 and the mesh (parallel/mesh.py) on one card. K2's forward with the
# shard's offsets at the BERT-base train shape (B 12, N 512, H 12, dropout
# 0.1, key bias) over 4 batch shards and over 2 x 2 batch x head shards;
# K1 at the headline M 6168 over 4 row shards and over 4 hidden slices (H
# 1536 / 4), K3 at HuBERT-base's M 4776 over 4 row shards. Then the
# trainer through a one-rank NCCL group, 22 steps each: ViT-B/16 SRFlexMatch
# on the imagenet_stretch YAML at depth 2 and 64 + 64 (data x fsdp (1, 1), against
# the same run without a mesh), and the headline ViT-S/2-32 at depth 2 on a
# data mesh (1,) and, with split_qkv, on data x model (1, 1)
MESH_K2_SHARDS = (("flash_attention_sharded_fwd", 4, 1),
                  ("flash_attention_sharded_heads_fwd", 2, 2))
MESH_MLP_SHARDS = (("fused_mlp_sharded", 6168, 384, 1536, "rows"),
                   ("fused_mlp_tp_sharded", 6168, 384, 1536, "hidden"),
                   ("fused_mlp_blocked_sharded", 4776, 768, 3072, "rows"))
MESH_SHARDS = 4
MESH_STEPS, MESH_LOG_EVERY = 22, 11  # past the harness's stage-2 checks
# the ViT-B/16 runs on seeded synthetic 224 px arrays of the YAML's 1000
# classes (one label each), made once for both, so that the phase runs
# before the JPEG folders exist
MESH_VITB = {**VITB_OVERRIDES, "dataset": "synthetic", "num_labels": 1000,
             "synthetic_train": 1024, "synthetic_test": 64, "batch_size": 64,
             "net_kwargs": {"depth": 2}}
MESH_VITS = {"net_kwargs": {"depth": 2}, "p_cutoff": 0.0}


def _shard_mesh(nb: int, nm: int, rank: int):
    """The mesh coordinate ``rank`` of an ``nb`` x ``nm`` data x model
    layout (data alone where ``nm`` is 1) without process groups: its
    collectives are identities, so a K4 wrapper called on that rank's
    slice gives that rank's part."""
    from semireward_tpu_torch.parallel.mesh import Mesh
    if nm == 1:
        return Mesh((nb,), ("data",), rank=rank, groups=False)
    return Mesh((nb, nm), ("data", "model"), rank=rank, groups=False)


def _k2_shard_rows(A):
    """K4's attention form, ``flash_attention_sharded``, on each shard's
    rows and heads (its mesh coordinate set, no groups): out and dq / dk /
    dv bit-equal to the slices of one whole ``flash_attention`` call, and
    the kernel's lse and keep bits at the wrapper's offsets bit-equal to
    the whole call's; the whole call's bits are the plain stream's, with
    the seed as one value or as ``seed_arg``'s four; each layout's first
    shard's wrapper against the plain version, and timed."""
    dev = torch.device("cuda")
    B, N, H, d, rate = 12, 512, 12, 64, 0.1
    q, k, v, do, bias4 = _attn_inputs(B, N, H, d, True)
    kb = A._key_bias_of(bias4, B, H, N)
    seed = torch.tensor([20240601], dtype=torch.int32, device=dev)
    out, lse, bits = A.kernel_fwd(q, k, v, kb, seed, rate, keep_bits=True)
    _, _, bits4 = A.kernel_fwd(q, k, v, kb, A.seed_arg(seed, dev, H), rate,
                               keep_bits=True)
    want = A.pack_keep_bits(A.attention_keep_mask(
        seed, B * H, N, A.padded_len(N), A.keep_threshold(rate)))
    if not (torch.equal(bits, want) and torch.equal(bits4, want)):
        raise AssertionError("the unsharded K2 call's bits left the stream")
    print("k2 unsharded: keep bits = the plain stream, one-value and "
          "four-value seed: ok")
    qw, kw, vw = (t.detach().clone().requires_grad_() for t in (q, k, v))
    whole = A.flash_attention(qw, kw, vw, bias4, rate, seed)
    grads = torch.autograd.grad(whole, (qw, kw, vw), do)
    if not torch.equal(whole, out):
        raise AssertionError("flash_attention's out is not its kernel's")
    per_bh = lambda t: t.view(B, H, *t.shape[1:])
    rows = {}
    for name, nb, nm in MESH_K2_SHARDS:
        r, hl = B // nb, H // nm
        for i in range(nb):
            for j in range(nm):
                mesh = _shard_mesh(nb, nm, i * nm + j)
                bs, hs = slice(i * r, (i + 1) * r), slice(j * hl, (j + 1) * hl)
                qs, ks, vs = (t[bs, :, hs].detach().clone().requires_grad_()
                              for t in (q, k, v))
                o = A.flash_attention_sharded(qs, ks, vs, bias4[bs], rate,
                                              seed, mesh=mesh)
                g = torch.autograd.grad(o, (qs, ks, vs),
                                        do[bs, :, hs].contiguous())
                s4 = A.seed_arg(seed, dev, hl, bh_offset=i * r * H + j * hl,
                                local_heads=hl, head_stride=H)
                _, l, b = A.kernel_fwd(qs.detach(), ks.detach(), vs.detach(),
                                       A._key_bias_of(bias4[bs], r, hl, N),
                                       s4, rate, keep_bits=True)
                torch.cuda.synchronize()
                same = (torch.equal(o, out[bs, :, hs])
                        and torch.equal(l, per_bh(lse)[bs, hs].reshape(-1, N))
                        and torch.equal(b, per_bh(bits)[bs, hs].reshape(
                            r * hl, N, -1))
                        and all(torch.equal(a, w[bs, :, hs])
                                for a, w in zip(g, grads)))
                if not same:
                    raise AssertionError(f"{name} shard ({i}, {j}) differs "
                                         f"from the whole call's slice")
        print(f"{name}: {nb} x {nm} shards of B {r}, H {hl} through "
              f"flash_attention_sharded: out and dq / dk / dv, lse and keep "
              f"bits bit-equal to the whole call's slices")
        # the first shard's wrapper against the plain version, and timed
        mesh = _shard_mesh(nb, nm, 0)
        qs, ks, vs = (t[:r, :, :hl].detach().clone().requires_grad_()
                      for t in (q, k, v))
        kbs = A._key_bias_of(bias4[:r], r, hl, N)
        s4 = A.seed_arg(seed, dev, hl, local_heads=hl, head_stride=H)
        plain_args = (qs.detach(), ks.detach(), vs.detach(), kbs, s4, rate)

        def wrapper():
            return A.flash_attention_sharded(qs, ks, vs, bias4[:r], rate,
                                             seed, mesh=mesh)

        o = wrapper()
        err = check_close(f"{name} out", o, A.plain_fwd(*plain_args)[0],
                          1e-2)
        ql, kl, vl = (t.detach().transpose(1, 2).contiguous()
                      for t in (qs, ks, vs))
        mask = bias4[:r].to(torch.bfloat16)
        flops = 2.0 * 2 * r * hl * N * N * d
        lse_s = torch.empty(r * hl, N, device=dev)
        bnd, by = bound_ms(nbytes(*plain_args[:5], o, lse_s), flops)
        rows[name] = dict(
            max_abs_err=err, ms=time_ms(wrapper),
            plain_ms=time_ms(lambda: A.plain_fwd(*plain_args), iters=5),
            bound_ms=bnd, bound_by=by,
            library_ms=time_ms(lambda: torch.nn.functional.
                               scaled_dot_product_attention(
                                   ql, kl, vl, attn_mask=mask,
                                   dropout_p=rate)))
        print(json.dumps({"kernel": name, "B": r, "N": N, "H": hl,
                          "shards": [nb, nm], **rows[name]}))
    return rows


def _mlp_shard_rows(F):
    """K4's MLP forms, ``fused_mlp_sharded`` per row shard and
    ``fused_mlp_tp_sharded`` per hidden slice (each shard's mesh coordinate
    set, no groups), through autograd, against one whole ``fused_mlp``
    call: the rows' outputs and dx, dW / db summed over the shards (the
    step's sync); the hidden slices' outputs with a zero b2 (the partials)
    and dx summed (the form's sums over ``model``) plus b2 once, dW1 / db1
    / dW2 the whole call's slices,
    db2 its column sums; within the kernels' tolerances (1e-2 of
    max|whole| for the bf16 tensors, 1e-3 for the f32 bias sums). Each
    form's first shard against the plain version, and its wrapper timed."""
    dev = torch.device("cuda")
    rows = {}
    for name, m, c, h, split in MESH_MLP_SHARDS:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(m, c, generator=g).to(dev, torch.bfloat16)
        w1 = (torch.randn(h, c, generator=g) * 0.05).to(dev, torch.bfloat16)
        b1 = (torch.randn(h, generator=g) * 0.1).to(dev)
        w2 = (torch.randn(c, h, generator=g) * 0.05).to(dev, torch.bfloat16)
        b2 = (torch.randn(c, generator=g) * 0.1).to(dev)
        gy = torch.randn(m, c, generator=g).to(dev, torch.bfloat16)
        leaves = lambda ts: [t.detach().clone().requires_grad_() for t in ts]
        whole_in = leaves((x, w1, b1, w2, b2))
        out = F.fused_mlp(*whole_in)
        dx, dw1, db1, dw2, db2 = torch.autograd.grad(out, whole_in, gy)
        n = MESH_SHARDS
        if split == "rows":
            mr = m // n
            shard = lambda i: (x[i * mr:(i + 1) * mr], w1, b1, w2, b2,
                               gy[i * mr:(i + 1) * mr])
            call = lambda i, t: F.fused_mlp_sharded(
                *t, mesh=_shard_mesh(n, 1, i))
        else:
            # a zero b2: each output is the partial the form sums over
            # ``model`` before it adds b2 (the timed call takes the real b2)
            hs, zero = h // n, torch.zeros_like(b2)
            shard = lambda i: (x, w1[i * hs:(i + 1) * hs],
                               b1[i * hs:(i + 1) * hs],
                               w2[:, i * hs:(i + 1) * hs], zero, gy)
            call = lambda i, t: F.fused_mlp_tp_sharded(
                *t, mesh=_shard_mesh(1, n, i), hidden=h)
        kind = F.route(c, shard(0)[1].shape[0], dev)
        outs, parts = [], []
        for i in range(n):
            ins = leaves(shard(i)[:5])
            outs.append(call(i, ins))
            parts.append(torch.autograd.grad(outs[-1], ins, shard(i)[5]))
        torch.cuda.synchronize()
        if split == "rows":
            got = {"out": torch.cat(outs), "dx": torch.cat([p[0] for p in parts]),
                   **{k: sum(p[i].float() for p in parts)
                      for i, k in ((1, "dw1"), (3, "dw2"), (2, "db1"),
                                   (4, "db2"))}}
        else:
            got = {"out": sum(o.float() for o in outs) + b2,
                   "dx": sum(p[0].float() for p in parts),
                   "dw1": torch.cat([p[1] for p in parts]),
                   "dw2": torch.cat([p[3] for p in parts], 1),
                   "db1": torch.cat([p[2] for p in parts]),
                   "db2": parts[0][4]}
        want = {"out": out, "dx": dx, "dw1": dw1, "dw2": dw2, "db1": db1,
                "db2": db2}
        print(f"{name}: M={m} C={c} H={h} {n} {split} shards through the "
              f"K4 wrapper ({kind})")
        for k, w in want.items():
            check_close(f"  {k} of the shards vs the whole call", got[k], w,
                        1e-3 if k.startswith("db") else 1e-2)
        xs, w1s, b1s, w2s, zero, gs = shard(0)
        w2s, b2s = w2s.contiguous(), b2
        ins = leaves((xs, w1s, b1s, w2s, b2s))
        y = call(0, ins)
        if split == "rows":
            zero = b2s
        plain_out = F.plain_fwd(xs, w1s, b1s, w2s, zero) + (b2s - zero)
        err_f = check_close(f"{name} shard fwd", y, plain_out, 1e-2)
        p_dx, p_dw1, p_dw2, p_db1, p_db2 = F.plain_bwd(xs, w1s, b1s, w2s, gs)
        err_b = max(check_close(f"{name} shard bwd {k}", a, b,
                                1e-3 if k.startswith("db") else 1e-2)
                    for k, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"),
                                       parts[0],
                                       (p_dx, p_dw1, p_db1, p_dw2, p_db2)))
        ms, cs, hs_ = xs.shape[0], xs.shape[1], w1s.shape[0]
        xl, w1l, b1l, w2l, b2l = (t.detach().clone().requires_grad_()
                                  for t in (xs, w1s, b1s.bfloat16(), w2s,
                                            b2s.bfloat16()))

        def lib_fwd():
            return torch.addmm(b2l, torch.nn.functional.gelu(
                torch.addmm(b1l, xl, w1l.t())), w2l.t())

        lib_out = lib_fwd()
        bf, byf = bound_ms(nbytes(xs, w1s, b1s, w2s, b2s, outs[0]),
                           4.0 * ms * cs * hs_)
        bb, byb = bound_ms(nbytes(xs, w1s, b1s, w2s, gs, *parts[0]),
                           10.0 * ms * cs * hs_)
        rows[f"{name}_fwd"] = dict(
            max_abs_err=err_f, ms=time_ms(lambda: call(0, ins)),
            plain_ms=time_ms(lambda: F.plain_fwd(xs, w1s, b1s, w2s, b2s)),
            bound_ms=bf, bound_by=byf,
            library_ms=time_ms(lambda: lib_fwd().detach()))
        rows[f"{name}_bwd"] = dict(
            max_abs_err=err_b,
            ms=time_ms(lambda: torch.autograd.grad(y, ins, gs,
                                                   retain_graph=True)),
            plain_ms=time_ms(lambda: F.plain_bwd(xs, w1s, b1s, w2s, gs)),
            bound_ms=bb, bound_by=byb,
            library_ms=time_ms(lambda: torch.autograd.grad(
                lib_out, (xl, w1l, b1l, w2l, b2l), gs, retain_graph=True)))
        for k in (f"{name}_fwd", f"{name}_bwd"):
            print(json.dumps({"kernel": k, "M": ms, "C": cs, "H": hs_,
                              "shards": n, "split": split, **rows[k]}))
    return rows


def mesh_phase(F, A):
    """K4 on the card (``_k2_shard_rows``, ``_mlp_shard_rows``), then the
    trainer through a one-rank NCCL group, each run a ``train_phase`` with
    its exact launch counts: the ViT-B/16 run with a data x fsdp (1, 1)
    mesh gives the losses of the run without one, and the K4 forms' own
    counts (``launches_k4``), set to 0 before the runs and read after,
    show that the runs went through them. Returns (the rows, their
    launches, each run's launches)."""
    from semireward_tpu_torch.parallel import mesh as mesh_lib

    rows = _k2_shard_rows(A)
    rows.update(_mlp_shard_rows(F))
    k3 = ("fused_mlp_blocked_fwd", "fused_mlp_blocked_bwd")
    k2 = ("flash_attention_fwd", "flash_attention_bwd")
    k1 = ("fused_mlp_fwd", "fused_mlp_bwd")
    logs = {}
    from semireward_tpu_torch.data.datasets import get_dataset
    from semireward_tpu_torch.profile_step import synthetic_config
    vitb_data = get_dataset(synthetic_config(VITB_YAML, MESH_VITB))

    k4_runs = {}

    def losses(name):
        def after(trainer):
            # the run's K4 counts (each phase sets every count to 0 first)
            k4_runs[name] = {**F.launches_k4, **A.launches_k4}
            logs[name] = [{k: h[k] for k in ("total_loss", "sup_loss",
                                             "unsup_loss") if k in h}
                          for h in trainer.log_history]
            return {"mesh": repr(trainer.mesh), "k4_launches": k4_runs[name]}
        return after

    runs = [train_phase("mesh_vitb16_no_mesh", VITB_YAML, MESH_VITB,
                        MESH_STEPS, MESH_LOG_EVERY, F, A, k2 + k3,
                        after=losses("no_mesh"), bundle=vitb_data)]
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1"}
    os.environ.update(env)
    try:
        for name, yaml_path, over, kernels, data in (
                ("mesh_vitb16_data_fsdp", VITB_YAML,
                 {**MESH_VITB, "mesh_shape": (1, 1),
                  "mesh_axes": ("data", "fsdp")}, k2 + k3, vitb_data),
                ("mesh_vits_data", HEADLINE_YAML,
                 {**MESH_VITS, "mesh_shape": (1,), "mesh_axes": ("data",)},
                 k1 + k2, None),
                ("mesh_vits_data_model", HEADLINE_YAML,
                 {**MESH_VITS, "mesh_shape": (1, 1),
                  "mesh_axes": ("data", "model"),
                  "net_kwargs": {**MESH_VITS.get("net_kwargs", {}), "depth": 2,
                                 "split_qkv": True}}, k1 + k2, None)):
            runs.append(train_phase(name, yaml_path, over, MESH_STEPS,
                                    MESH_LOG_EVERY, F, A, kernels,
                                    cfg_extra={"multihost": True},
                                    after=losses(name), bundle=data))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        mesh_lib.activate(None)
        for k in env:
            os.environ.pop(k, None)
    k4 = {k: sum(k4_runs[r][k] for r in k4_runs if r != "no_mesh")
          for k in k4_runs["no_mesh"]}
    if any(k4_runs["no_mesh"].values()):
        raise AssertionError(f"a K4 form ran without a mesh: {k4_runs}")
    a, b = logs["no_mesh"], logs["mesh_vitb16_data_fsdp"]
    if not a or len(b) != len(a) or any(
            abs(x[k] - y[k]) > 1e-5 * max(abs(y[k]), 1e-6)
            for x, y in zip(b, a) for k in y):
        raise AssertionError(f"the one-rank mesh run's losses {b} differ "
                             f"from the run without a mesh {a}")
    print(f"mesh: the logged losses of the (1, 1) data x fsdp run ({len(a)} "
          f"windows) are the run without a mesh's (1e-5): ok")
    # every MLP and attention call of the mesh runs went through a K4
    # form: the forms' own counts are the runs' kernel forwards
    vitb, vits, tp = runs[1:]
    if not (k4["fused_mlp_sharded"] == vitb["fused_mlp_blocked_fwd"]
            + vits["fused_mlp_fwd"] > 0
            and k4["fused_mlp_tp_sharded"] == tp["fused_mlp_fwd"] > 0
            and k4["flash_attention_sharded"] == vitb["flash_attention_fwd"]
            + vits["flash_attention_fwd"] > 0
            and k4["flash_attention_sharded_heads"]
            == tp["flash_attention_fwd"] > 0):
        raise AssertionError(f"the mesh runs' kernels did not all go "
                             f"through the K4 forms: {k4}")
    print(f"mesh: K4 launches {json.dumps(k4)}: every kernel forward of "
          f"the mesh runs: ok")
    launches = {
        "flash_attention_sharded_fwd": k4["flash_attention_sharded"],
        "flash_attention_sharded_heads_fwd":
            k4["flash_attention_sharded_heads"],
        "fused_mlp_sharded_fwd": vits["fused_mlp_fwd"],
        "fused_mlp_sharded_bwd": vits["fused_mlp_bwd"],
        "fused_mlp_blocked_sharded_fwd": vitb["fused_mlp_blocked_fwd"],
        "fused_mlp_blocked_sharded_bwd": vitb["fused_mlp_blocked_bwd"],
        "fused_mlp_tp_sharded_fwd": tp["fused_mlp_fwd"],
        "fused_mlp_tp_sharded_bwd": tp["fused_mlp_bwd"]}
    return rows, launches, runs


def reverb_spy():
    """Count the calls of the port's two reverbs (``data/audio.py``) until
    the returned undo; returns the counts and the undo."""
    from semireward_tpu_torch.data import audio

    calls, orig = {}, {}
    for name in ("_sox_reverb_wet", "_sox_reverb_wet_exact"):
        calls[name], orig[name] = 0, getattr(audio, name)

        def spy(x, name=name):
            calls[name] += 1
            return orig[name](x)

        setattr(audio, name, spy)
    return calls, lambda: [setattr(audio, n, f) for n, f in orig.items()]


def fast_reverb_checks(calls, undo):
    """``audio_fast_reverb``'s own checks, after its run: the strong views
    took the fast reverb and never the exact one; on the card the fast
    reverb equals the CPU's (1e-5 of the largest magnitude) and stays
    within the bound of the JAX package's ``tests/test_modalities.py::
    TestSoxEffectKernels::test_fast_reverb_bounded_vs_exact`` against the
    exact one: the same first echo (sample 405), the octave-band energies
    of the impulse responses within its factors, the broadband energy
    within 4x."""
    from semireward_tpu_torch.data import audio

    def after(trainer):
        undo()
        assert calls["_sox_reverb_wet"] > 0, calls
        assert calls["_sox_reverb_wet_exact"] == 0, calls
        x = torch.randn(8, 64000, generator=torch.Generator().manual_seed(0))
        err = check_close("fast reverb, card against CPU",
                          audio._sox_reverb_wet(x.cuda()).cpu(),
                          audio._sox_reverb_wet(x), 1e-5)
        imp = torch.zeros(1, 16000, device="cuda")
        imp[0, 0] = 1.0
        h_fast = audio._sox_reverb_wet(imp)[0].cpu().numpy()
        h_exact = audio._sox_reverb_wet_exact(imp)[0].cpu().numpy()
        first = [int(np.nonzero(np.abs(h) > 1e-6)[0][0])
                 for h in (h_fast, h_exact)]
        assert first == [405, 405], first
        Hf, He = np.abs(np.fft.rfft(h_fast)), np.abs(np.fft.rfft(h_exact))
        freqs = np.fft.rfftfreq(16000, 1 / 16000)
        ratios = []
        for (lo, hi), top in zip([(62, 250), (250, 1000), (1000, 4000),
                                  (4000, 8000)], (2.0, 3.0, 5.0, 8.0)):
            sel = (freqs >= lo) & (freqs < hi)
            ratios.append(float((Hf[sel] ** 2).sum() / (He[sel] ** 2).sum()))
            assert 0.8 < ratios[-1] < top, (lo, hi, ratios)
        tot = float((h_fast ** 2).sum() / (h_exact ** 2).sum())
        assert 0.5 < tot < 4.0, tot
        print(f"  fast reverb: {calls} calls; octave-band energy ratios to "
              f"the exact one {ratios}, broadband {tot:.3f}, first echo "
              f"{first}")
        return {"reverb_calls": dict(calls), "band_energy_ratios": ratios,
                "broadband_ratio": tot, "card_vs_cpu_max_abs_err": err}

    return after


def text_audio_phases(F, A):
    """The text and audio forms of MixMatch, ReMixMatch and VAT, the fast
    reverb and DNABERT-2 (``TEXT_AUDIO_PHASES``), through K2 and K3;
    returns each phase's launches."""
    k23 = ("flash_attention_fwd", "flash_attention_bwd",
           "fused_mlp_blocked_fwd", "fused_mlp_blocked_bwd")
    out = []
    for name, rel, over, extra in TEXT_AUDIO_PHASES:
        after = None
        if extra.get("audio_exact_reverb") is False:
            after = fast_reverb_checks(*reverb_spy())
        out.append(train_phase(
            name, os.path.join(HERE, f"config/{rel}.yaml"), over,
            TEXT_AUDIO_STEPS, TEXT_AUDIO_LOG_EVERY, F, A, k23,
            cfg_extra=extra, after=after))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # the trainers' log and eval lines go to stderr as they come
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    from semireward_tpu_torch.ops import _build
    from semireward_tpu_torch.ops import attention as A
    from semireward_tpu_torch.ops import fused_mlp as F

    t_start = time.time()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    built = timed("build", _build.build_all)
    print(f"built {sorted(built) or 'nothing (cached)'}")
    for name in _build.sources():
        text = _build.compiler_log(name)
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1])
            if "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if (name in ("fused_mlp", "fused_mlp_blocked", "flash_attention")
                    and spill
                    and spill.groups() != ("0", "0")):
                raise AssertionError(f"{name} kernel {entry} spills: {line}")

    kernels = timed("k1_k3", fused_mlp_phase, F)
    from semireward_tpu_torch import k3_profile
    # K1's and K3's time by GEMM, one JSON line each
    t0 = time.time()
    print(json.dumps({"k1_breakdown": k3_profile.breakdown(6168, 384, 1536),
                      "card": card}))
    for m in (4776, 6144, 151296):
        print(json.dumps({"k3_breakdown": k3_profile.breakdown(m),
                          "card": card}))
    print(json.dumps({"k3_breakdown": k3_profile.breakdown(12336, 1024, 4096),
                      "shape": "dinov2_vitl14", "card": card}))
    PHASE_SECONDS["k1_k3_breakdown"] = time.time() - t0
    kernels.update(timed("k2", flash_phase, A, k3_profile.FLASH_SHAPES))
    # K2's time by kernel, launches and host time a call at the train shapes
    # and ViT-B/16's at 224 px
    t0 = time.time()
    for name, shape in (*k3_profile.FLASH_SHAPES.items(),
                        ("vit_b16_224", (768, 197, 12, False, 0.0))):
        print(json.dumps({"k2_breakdown": k3_profile.flash_breakdown(*shape),
                          "shape": name, "card": card}))
    PHASE_SECONDS["k2_breakdown"] = time.time() - t0
    k3 = ("fused_mlp_blocked_fwd", "fused_mlp_blocked_bwd")
    k2 = ("flash_attention_fwd", "flash_attention_bwd")
    k1 = ("fused_mlp_fwd", "fused_mlp_bwd")
    # K4 and the mesh through a one-rank NCCL group, first: a fault of the
    # slice shows within the smoke's first minutes; and before the JPEG
    # writer's processes share the host with the K4 wrappers' timings (a
    # wrapper's time is mostly its host's)
    mesh_rows, mesh_launches, mesh_runs = timed("mesh", mesh_phase, F, A)
    folders = write_jpeg_folders()
    phases = [
        train_phase("vit", HEADLINE_YAML, {}, TRAIN_STEPS, LOG_EVERY, F, A,
                    k1 + k2),
        train_phase("bert", NLP_YAML, {}, BERT_STEPS, BERT_LOG_EVERY, F, A,
                    k2 + k3),
        train_phase("audio", AUDIO_YAML, {}, AUDIO_STEPS, AUDIO_LOG_EVERY, F,
                    A, k2 + k3),
        train_phase("vit_srfreematch", FREE_YAML, {}, FREE_STEPS, 25, F, A,
                    k1 + k2),
        train_phase("vit_srsoftmatch", SOFT_YAML, {}, SOFT_STEPS, 25, F, A,
                    k1 + k2),
        train_phase("vit_srpseudolabel", PL_YAML, {}, PL_STEPS, 25, F, A,
                    k1 + k2),
        # no Pallas kernel covers the WRN step: no kernel of the port runs
        train_phase("wrn_srfixmatch", WRN_FIX_YAML, {}, WRN_STEPS, 25, F, A,
                    ()),
        train_phase("wrn_srpseudolabel", WRN_PL_YAML, {}, WRN_STEPS, 25, F,
                    A, ()),
        timed("vit_resume", resume_phase, F, A)]
    # the USB base algorithms on the ViT-S/2-32 path (K1 and K2)
    phases += [train_phase(f"vit_{a}", USB_YAML[a], USB_OVERRIDES.get(a, {}),
                           USB_STEPS, USB_LOG_EVERY, F, A, k1 + k2)
               for a in USB_ALGOS]
    # CoMatch and SimMatch: ViT-S through K1 and K2, BERT-base and
    # HuBERT-base through K2 and K3
    for name, rel, steps, per_epoch, over in CO_SIM_PHASES:
        path = os.path.join(HERE, rel)
        phases.append(train_phase(
            name, path, {"p_cutoff": 0.0,
                         "epoch": _num_train_iter(path) // per_epoch,
                         **over},
            steps, per_epoch // 2, F, A,
            k2 + (k1 if name.startswith("vit") else k3)))
    # SemiReward's reference-equivalent arm and per-sample mode, at
    # p_cutoff 0: FlexMatch's selected_label moves within the short phases
    phases.append(train_phase("vit_srflexmatch_reforward", HEADLINE_YAML,
                              {"p_cutoff": 0.0}, REFORWARD_STEPS, 10, F, A,
                              k1 + k2, cfg_extra={"sr_reforward": REFORWARD}))
    phases.append(train_phase("vit_srflexmatch_per_sample", HEADLINE_YAML,
                              {"sr_per_sample": True, "p_cutoff": 0.0},
                              PER_SAMPLE_STEPS, 10, F, A, k1 + k2))
    # the imbalanced-SSL wrappers on WRN-28-2 (no kernel of the port runs)
    imb_over = {**IMB_OVERRIDES, "num_eval_iter": IMB_EVAL_EVERY,
                "p_cutoff": 0.0,
                "epoch": _num_train_iter(imb_yaml("fixmatch", "saw"))
                // IMB_PER_EPOCH}
    # every imb YAML names one split of one data set: made once
    from semireward_tpu_torch.data.datasets import get_dataset
    from semireward_tpu_torch.profile_step import synthetic_config
    imb_data = get_dataset(synthetic_config(imb_yaml("fixmatch", "saw"),
                                            imb_over))
    for imb in IMB_NAMES:
        phases.append(train_phase(f"imb_{imb}", imb_yaml("fixmatch", imb),
                                  imb_over, IMB_STEPS, IMB_LOG_EVERY, F, A,
                                  (), bundle=imb_data))
    for imb in ("abc", "daso"):
        phases.append(train_phase(f"imb_remixmatch_{imb}",
                                  imb_yaml("remixmatch", imb), imb_over,
                                  IMB_STEPS, IMB_LOG_EVERY, F, A, (),
                                  bundle=imb_data))
    del imb_data
    phases.append(timed("imb_crest_gens", crest_phase, F, A))
    # the wrapper code under K1 and K2: ABC over FixMatch on the headline
    # ViT-S/2-32 (its head reads the features out of K1 and K2), and
    # SemiReward over Dash (registered through _make_sr_variant; Dash's
    # warm-up reached through the wrapper)
    phases.append(train_phase("vit_abc", USB_FIX_YAML, {
        "imb_algorithm": "abc", "p_cutoff": 0.0,
        "epoch": _num_train_iter(USB_FIX_YAML) // 40}, USB_STEPS,
        USB_LOG_EVERY, F, A, k1 + k2))
    from semireward_tpu_torch.algorithms.semireward import _make_sr_variant
    from semireward_tpu_torch.registry import ALGORITHMS
    if "srdash" not in ALGORITHMS:
        _make_sr_variant("srdash", "dash")
    phases.append(train_phase("vit_srdash", USB_YAML["dash"], {
        "algorithm": "srdash", "num_wu_iter": 20}, USB_STEPS,
        USB_LOG_EVERY, F, A, k1 + k2))
    # the text and audio forms of MixMatch, ReMixMatch and VAT, the fast
    # reverb and DNABERT-2 on BERT-base / HuBERT-base geometry (K2 + K3)
    phases += text_audio_phases(F, A)
    # the JPEG folders' decode on the card against the CPU route, then the
    # ViT-B/16 and ResNet-50 phases on those folders
    timed("jpeg_decode", jpeg_phase, folders)
    phases += new_phases(F, A)
    # DINOv2 ViT-L/14 (K3 at C 1024) and the ViT-B/14 regression run
    dino = dinov2_phases(F, A)
    phases += dino
    phases += mesh_runs
    launches = {k: sum(p[k] for p in phases) for k in phases[0]}
    # the C 1024 rows: the launches of the ViT-L/14 phase, all at C 1024
    for k in ("fused_mlp_blocked_fwd", "fused_mlp_blocked_bwd"):
        launches[f"{k}_c1024"] = dino[0][k]

    where = {"fused_mlp_fwd": ("fused_mlp.cu", "fused_mlp.py:71"),
             "fused_mlp_bwd": ("fused_mlp.cu", "fused_mlp.py:107"),
             "fused_mlp_blocked_fwd": ("fused_mlp_blocked.cu",
                                       "fused_mlp.py:202"),
             "fused_mlp_blocked_bwd": ("fused_mlp_blocked.cu",
                                       "fused_mlp.py:319"),
             "flash_attention_fwd": ("flash_attention.cu", "attention.py:110"),
             "flash_attention_bwd": ("flash_attention.cu", "attention.py:372")}
    where.update({f"{k}_c1024": where[k] for k in ("fused_mlp_blocked_fwd",
                                                   "fused_mlp_blocked_bwd")})
    line = [{"name": name, "route": "cuda",
             "source": f"semireward_tpu_torch/csrc/{where[name][0]}",
             "replaces": f"semireward_tpu/ops/{where[name][1]}",
             "launches": launches[name],
             **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}}
            for name, r in kernels.items()]
    # K4: JAX's shard_map forms around the same kernels, one rank's call
    k4_where = {
        "flash_attention_sharded_fwd": ("flash_attention.cu",
                                        "attention.py:548"),
        "flash_attention_sharded_heads_fwd": ("flash_attention.cu",
                                              "attention.py:548"),
        "fused_mlp_sharded": ("fused_mlp.cu", "fused_mlp.py:614"),
        "fused_mlp_blocked_sharded": ("fused_mlp_blocked.cu",
                                      "fused_mlp.py:614"),
        "fused_mlp_tp_sharded": ("fused_mlp.cu", "fused_mlp.py:523")}
    for name, r in mesh_rows.items():
        form = name if name in k4_where else name[:-4]
        line.append({"name": name, "route": "cuda",
                     "source": f"semireward_tpu_torch/csrc/"
                               f"{k4_where[form][0]}",
                     "replaces": f"semireward_tpu/ops/{k4_where[form][1]}",
                     "launches": mesh_launches[name],
                     **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}})
    for k in line:
        assert k["launches"] > 0, f"{k['name']} never launched on the path"
    print(card)
    print(json.dumps({"kernels": line}), flush=True)
    # the golden checks run no kernel of the port (their launches are held
    # at 0), so the kernels line stands before them; a failed bound still
    # ends the run before the ok line
    timed("golden", golden_phase, F, A)
    print(json.dumps({"phase_seconds": PHASE_SECONDS}))
    print(f"smoke total: {time.time() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
