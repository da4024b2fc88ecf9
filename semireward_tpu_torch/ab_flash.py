"""A/B of a knob of the training step, on one CUDA card.

    python -m semireward_tpu_torch.ab_flash [--knob use_flash_attention]
        [--configs bert_base_L512,vit_small_N257,hubert_base_N199]
        [--steps 100] [--warmup 30] [--out ab.json]

For each named config (the usb_nlp BERT-base config
config/SemiReward/usb_nlp/flexmatch/flexmatch_aclImdb_100_0.yaml, the
headline ViT-S config, the usb_audio HuBERT-base config
config/SemiReward/usb_audio/flexmatch/flexmatch_esc50_250_0.yaml; the
imagenet_stretch ViT-B/16 and ImageNet-127 ResNet-50 YAMLs on their seeded
JPEG folders, ``vit_base_jpeg`` and ``resnet50_jpeg``), builds
two trainers with ``--knob`` on and off as ``profile_step.synthetic_config``
sets them up (``use_flash_attention``, K2, or ``use_fused_mlp``, K1/K3:
True / False; ``prefetch_depth``, the producer thread that assembles the
host batches: 2 / 0), warms each up, then times windows of ``--steps``
steps in the order on, off, off, on (host clock, each window ends in a
device sync; each step takes its raw batch from the trainer's train
stream, as ``Trainer.train`` does) so a drift of the host shows as a
difference between the two windows of one arm. Prints one JSON object
with steps/s per window and per arm and the card's name and power limit.
The flash numbers set ``flash_auto_default`` and the prefetch numbers the
``prefetch_depth`` default in ``core/trainer.py``; the fused-MLP default
follows the JAX package, and its A/B is recorded only.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import time

import torch

from semireward_tpu_torch.profile_step import HEADLINE, synthetic_config

NLP = "config/SemiReward/usb_nlp/flexmatch/flexmatch_aclImdb_100_0.yaml"
AUDIO = "config/SemiReward/usb_audio/flexmatch/flexmatch_esc50_250_0.yaml"
# each knob's (on, off) values
KNOBS = {"use_flash_attention": (True, False), "use_fused_mlp": (True, False),
         "prefetch_depth": (2, 0)}
VITB = ("config/SemiReward/imagenet_stretch/flexmatch/"
        "flexmatch_imagenet_100000_0.yaml")
RESNET = ("config/classic_cv_imb/fixmatch/"
          "fixmatch_imagenet127_lb128101_286_ulbNone_286_0.yaml")
CONFIGS = {
    "bert_base_L512": (NLP, {}),
    "vit_small_N257": (HEADLINE, {}),
    "hubert_base_N199": (AUDIO, {}),
    # the JPEG-folder YAMLs at chip_smoke.py's cuts, on their seeded
    # folders decoded on the card
    "vit_base_jpeg": (VITB, {"num_labels": 2000, "synthetic_train": 4096,
                             "p_cutoff": 0.0}),
    "resnet50_jpeg": (RESNET, {"num_labels": 286, "ulb_num_labels": 572,
                               "synthetic_train": 16384, "p_cutoff": 0.0}),
}


def _window(trainer, loader, steps: int) -> float:
    """Steps/s of ``steps`` train steps, as ``Trainer.train`` runs them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer._step(trainer.state, trainer.make_batch(next(loader)),
                      trainer.generator)
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def ab(path: str, overrides: dict, steps: int, warmup: int,
       knob: str = "use_flash_attention") -> dict:
    from semireward_tpu_torch.core.trainer import Trainer

    on, off = KNOBS[knob]
    arms = {}
    for value in (on, off):
        cfg = synthetic_config(path, {**overrides, "num_log_iter": 10 ** 9,
                                      knob: value})
        trainer = Trainer(cfg)
        loader = trainer._train_loader()
        _window(trainer, loader, warmup)
        arms[value] = (trainer, loader)
    windows = []
    for value in (on, off, off, on):
        windows.append({knob: value,
                        "steps_per_sec": _window(*arms[value], steps)})
    for _, loader in arms.values():
        if hasattr(loader, "close"):
            loader.close()
    arms.clear()
    gc.collect()
    torch.cuda.empty_cache()
    mean = {arm: sum(w["steps_per_sec"] for w in windows
                     if w[knob] == arm) / 2 for arm in (on, off)}
    return {"config": path, "knob": knob, "overrides": overrides,
            "steps": steps, "warmup": warmup, "windows": windows,
            "on": on, "off": off, "on_steps_per_sec": mean[on],
            "off_steps_per_sec": mean[off],
            "on_over_off": mean[on] / mean[off]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--knob", default="use_flash_attention",
                    choices=sorted(KNOBS))
    ap.add_argument("--configs",
                    default="bert_base_L512,vit_small_N257,hubert_base_N199",
                    help="comma-separated names of CONFIGS")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {"card": card}
    for name in args.configs.split(","):
        path, overrides = CONFIGS[name]
        result[name] = ab(path, overrides, args.steps, args.warmup,
                          args.knob)
        print(json.dumps({name: result[name]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
