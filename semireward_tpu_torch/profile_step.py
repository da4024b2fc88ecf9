"""Where the time of the port's training step goes, on one CUDA card.

    python -m semireward_tpu_torch.profile_step [--steps 20] [--warmup 30]
        [--out profile.json]

Builds the port's Trainer on the headline config
(config/SemiReward/usb_cv/flexmatch/flexmatch_cifar100_200_0.yaml, synthetic
data, random weights, start_timing 10 so the measured steps are in stage 2),
runs ``--warmup`` steps, then traces ``--steps`` steps with torch.profiler
(CPU and CUDA). Prints one JSON object: wall time per step, device busy time
per step (union of kernel intervals) and the idle share, and device time per
kernel group (fused MLP kernels, other GEMMs, elementwise/reduction, ...)
and per top kernel. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict

import torch

HEADLINE = "config/SemiReward/usb_cv/flexmatch/flexmatch_cifar100_200_0.yaml"


def _group(name: str) -> str:
    n = name.lower()
    if "fwd_kernel" in n:
        return "fused_mlp_fwd"
    if "dx_kernel" in n or "dw_kernel" in n or "reduce_kernel" in n:
        return "fused_mlp_bwd"
    if "gemm" in n or "cutlass" in n or "sm90" in n or "matmul" in n:
        return "gemm (attention, qkv/proj, head, rewarder)"
    if "conv" in n:
        return "conv (patch embed)"
    if "softmax" in n:
        return "softmax"
    if "layer_norm" in n or "layernorm" in n:
        return "layer_norm"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer/EMA (foreach)"
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
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")

    from torch.profiler import ProfilerActivity, profile

    from semireward_tpu_torch import config as config_lib
    from semireward_tpu_torch.core.trainer import Trainer

    cfg = config_lib.from_yaml(args.config, {
        "dataset": "synthetic", "use_pretrain": False, "resume": False,
        "start_timing": 10, "N_k": 10, "num_log_iter": 10 ** 9})
    trainer = Trainer(cfg)
    trainer.train(num_iters=args.warmup)
    torch.cuda.synchronize()

    loader = trainer._make_loader()
    batches = [next(loader) for _ in range(args.steps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for raw in batches:
            trainer._step(trainer.state, trainer.make_batch(raw),
                          trainer.generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

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
        "card": card, "config": args.config, "steps": n,
        "wall_ms_per_step": wall * 1e3 / n,
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
