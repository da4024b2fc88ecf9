"""The golden-learning quality sweep on the port (counterpart of the JAX
package's ``scripts/golden_quality.py``): evidence that every algorithm
family learns on the port.

    python -m semireward_tpu_torch.golden_quality [--seed 0] [--iters 1000]
        [--sr_iters 500] [--imb_iters 400] [--skip_extra] [--skip_imb]
        [--only ALG ...] [--tier base|hard] [--out_dir .]
        [--device cuda|cpu] [--rng_device cpu|cuda]

Runs on the card unless ``--device cpu``, drawing from a CPU generator
(the CPU run's draws) unless ``--rng_device cuda``. The report has the JAX
sweep's JSON keys: the labeled-only baseline (FixMatch with its unlabeled
loss zeroed), the 7 thresholding and 10 other families' accuracy and gain
over it, ``semireward_noise`` (40% uniform pseudo-label noise: noisy
FlexMatch with and without SemiReward, the class-level rewarder probe, and
the control run at the filter's measured keep rate),
``semireward_class_noise`` (classes 0 and 1 shifted by 3) and
``imbalanced`` (SAW, DebiasPL and ABC over FixMatch at ratio 10), plus
``device``: the card's name and power limit as ``nvidia-smi`` gives them,
and ``rng_device``. ``--only`` runs the baseline and the
named families alone (no SemiReward or imbalanced section). Writes
``QUALITY_torch_r<round>[_hard][_seed<N>].json`` into ``--out_dir``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess

import numpy as np
import torch

THRESHOLD_FAMILIES = ["fixmatch", "flexmatch", "freematch", "softmatch",
                      "uda", "adamatch", "dash"]
# the consistency / mixing / net-wrapper families (every other registered
# algorithm that trains on unlabeled data)
EXTRA_FAMILIES = ["pseudolabel", "meanteacher", "pimodel", "vat", "mixmatch",
                  "remixmatch", "comatch", "simmatch", "crmatch", "defixmatch"]
IMB_METHODS = ["saw", "debiaspl", "abc"]

log = logging.getLogger("semireward_tpu_torch.golden_quality")


def device_line(device: str):
    """The device the sweep ran on: the card's name and its ``nvidia-smi``
    name and power limit, or the CPU."""
    if device == "cpu":
        return {"platform": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi}


def _families(report, key, names, sup, args, run_golden, common):
    fam = report.setdefault(key, {})
    for alg in names:
        try:
            acc = run_golden(alg, iters=args.iters, lambda_u=1.0,
                             **common)["acc"]
        except Exception as e:  # keep the sweep going, record the failure
            log.exception(f"[golden] {alg} failed")
            fam[alg] = {"error": str(e)[:200]}
            continue
        fam[alg] = {"ssl_acc": acc, "gain_vs_labeled_only": acc - sup}
        print(f"[golden] {alg}: {acc:.4f} (labeled-only {sup:.4f})",
              flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--round", type=int, default=1)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--sr_iters", type=int, default=500)
    p.add_argument("--imb_iters", type=int, default=400)
    p.add_argument("--skip_imb", action="store_true")
    p.add_argument("--skip_extra", action="store_true",
                   help="skip the consistency / net-wrapper families")
    p.add_argument("--only", nargs="+", default=None, metavar="ALG",
                   help="the baseline and these families alone")
    p.add_argument("--seed", type=int, default=0,
                   help="data and init seed; a non-zero seed writes "
                        "QUALITY_torch_r<round>_seed<seed>.json")
    p.add_argument("--tier", default="base", choices=["base", "hard"],
                   help="golden tier (validation.golden_config); the hard "
                        "tier runs the family sweep only")
    p.add_argument("--save_dir", default=None,
                   help="where the runs write their checkpoints")
    p.add_argument("--out_dir", default=".")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--rng_device", default="cpu", choices=["cpu", "cuda"],
                   help="where the runs' generator draws (validation."
                        "run_golden)")
    args = p.parse_args(argv)

    from semireward_tpu_torch.validation import (imb_gain,
                                                 make_noisy_flexmatch,
                                                 run_golden,
                                                 sr_noise_experiment)

    suffix = ("_hard" if args.tier == "hard" else "") + (
        f"_seed{args.seed}" if args.seed else "")
    out_path = os.path.join(args.out_dir,
                            f"QUALITY_torch_r{args.round:02d}{suffix}.json")
    report = {"iters": args.iters, "seed": args.seed, "tier": args.tier,
              "device": device_line(args.device),
              "rng_device": args.rng_device}
    common = {"seed": args.seed, "device": args.device,
              "rng_device": args.rng_device}
    if args.save_dir:
        common["save_dir"] = args.save_dir

    # 1) the shared labeled-only baseline and every thresholding family
    sup = run_golden("fixmatch", iters=args.iters, lambda_u=0.0,
                     tier=args.tier, **common)["acc"]
    report["labeled_only_acc"] = sup
    pick = lambda names: [a for a in names
                          if args.only is None or a in args.only]
    _families(report, "thresholding_families", pick(THRESHOLD_FAMILIES), sup,
              args, run_golden, {**common, "tier": args.tier})
    # 1b) the other families
    if not args.skip_extra:
        _families(report, "other_families", pick(EXTRA_FAMILIES), sup, args,
                  run_golden, {**common, "tier": args.tier})
    if args.tier == "base" and args.only is None:
        # 2) SemiReward under uniform noise, and the control: the same
        # noisy FlexMatch with lambda_u at SR's measured count-weighted
        # keep rate (reward selection against mere downweighting)
        sr = sr_noise_experiment(noise_frac=0.4, iters=args.sr_iters,
                                 start_timing=120, **common)
        keep = np.asarray(sr["per_label_keep_rate"], float)
        cnt = np.asarray(sr["per_label_count"], float)
        lam = float((keep * cnt).sum() / max(cnt.sum(), 1.0))
        sr["control_lambda_u"] = lam
        noisy, _ = make_noisy_flexmatch(0.4)
        sr["control_downweighted_acc"] = run_golden(
            "flexmatch", alg_factory=lambda c, d, dev: noisy(c, d, dev),
            iters=args.sr_iters, lambda_u=lam, **common)["acc"]
        report["semireward_noise"] = sr
        print(f"[golden] sr noise: {json.dumps(sr, default=float)}",
              flush=True)
        # 2b) class-conditional noise: only pseudo-labels of classes 0 and
        # 1 are corrupted, the per-label filter the Rewarder can express
        cc = sr_noise_experiment(noise_frac=1.0, classes=(0, 1), shift=3,
                                 iters=args.sr_iters, start_timing=120,
                                 **common)
        report["semireward_class_noise"] = cc
        print(f"[golden] sr class-noise: {json.dumps(cc, default=float)}",
              flush=True)
        # 3) the imbalanced tier
        if not args.skip_imb:
            imb = {}
            for m in IMB_METHODS:
                imb[m] = imb_gain(m, gamma=10.0, iters=args.imb_iters,
                                  **common)
                print(f"[golden] imb {m}: {json.dumps(imb[m], default=float)}",
                      flush=True)
            report["imbalanced"] = imb

    os.makedirs(args.out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1, default=float)
    print(f"wrote {out_path}")
    return report


if __name__ == "__main__":
    main()
