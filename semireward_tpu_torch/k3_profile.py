"""Where a fused-MLP kernel's time goes: device time of each of its GEMMs.

    python -m semireward_tpu_torch.k3_profile [--m 4776 6144] [--iters 20]
    python -m semireward_tpu_torch.k3_profile --c 384 --h 1536 --m 6168

For each row count M (C 768 / H 3072 by default: K3; a width K1 takes, such
as ViT-S's 384 / 1536: K1; bf16, seeded inputs) runs the kernel's forward
and backward ``iters`` times under ``torch.profiler`` and prints one JSON
line: the plan (``ops/fused_mlp.py:blocked_plan``), the device microseconds
per call of every kernel (F1 ``k*_fwd_up``, F2 ``k*_fwd_down``; B1
``k*_bwd_dh``, B2 ``k*_bwd_dx``, B3 ``k*_bwd_dw``, ``k*_bwd_colsum``,
``k*_bwd_reduce``, with ``k1_`` or ``k3_`` before each) with its TFLOP/s,
and the forward and backward times by CUDA events, whose excess over the
kernels' sum is the host's share. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import defaultdict

import torch

from semireward_tpu_torch.ops import fused_mlp as F

# the products each GEMM computes, in units of 2*M*C*H flops
_PRODUCTS = {"fwd_up": 1, "fwd_down": 1, "bwd_dh": 2, "bwd_dx": 1,
             "bwd_dw": 2}


def _inputs(m, c, h, dev):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(m, c, generator=g).to(dev, torch.bfloat16),
            (torch.randn(h, c, generator=g) * 0.05).to(dev, torch.bfloat16),
            (torch.randn(h, generator=g) * 0.1).to(dev),
            (torch.randn(c, h, generator=g) * 0.05).to(dev, torch.bfloat16),
            (torch.randn(c, generator=g) * 0.1).to(dev),
            torch.randn(m, c, generator=g).to(dev, torch.bfloat16))


def _events_ms(fn, iters):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def breakdown(m: int, c: int = 768, h: int = 3072, iters: int = 20,
              bn=None) -> dict:
    """The kernel that ``route`` gives C, H (K1 or K3); ``bn`` forces that
    tile width on every GEMM that takes it (``blocked_plan``'s own choice
    otherwise)."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x, w1, b1, w2, b2, gy = _inputs(m, c, h, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernel = F.route(c, h, dev)
    plan = F.blocked_plan(m, c, h, sms, bn=bn, kernel=kernel)
    fwd_k, bwd_k = ((F.kernel_fwd, F.kernel_bwd) if kernel == "full"
                    else (F.kernel_blocked_fwd, F.kernel_blocked_bwd))

    def fwd():
        return fwd_k(x, w1, b1, w2, b2, plan=plan)

    def bwd():
        return bwd_k(x, w1, b1, w2, gy, plan=plan)

    for _ in range(3):
        fwd(), bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fwd(), bwd()
        torch.cuda.synchronize()
    us = defaultdict(float)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        found = re.search(r"(k[13]_\w+?)_kernel", e.name)
        if found:
            us[found.group(1)] += (e.time_range.end - e.time_range.start)
    flop = 2.0 * m * c * h
    kernels = {k: {"us": v / iters,
                   "tflops": (_PRODUCTS[k[3:]] * flop / (v / iters) / 1e6
                              if k[3:] in _PRODUCTS else None)}
               for k, v in sorted(us.items())}
    return {"kernel": kernel, "M": m, "C": c, "H": h,
            "plan": {k: (v["bn"], v["splits"], v["tiles"])
                     for k, v in plan.items()
                     if k not in ("sms", "workspace")},
            "kernels": kernels,
            "fwd_device_us": sum(v["us"] for k, v in kernels.items()
                                 if k[3:].startswith("fwd")),
            "bwd_device_us": sum(v["us"] for k, v in kernels.items()
                                 if k[3:].startswith("bwd")),
            "fwd_event_ms": _events_ms(fwd, iters),
            "bwd_event_ms": _events_ms(bwd, iters)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[4776, 6144])
    ap.add_argument("--c", type=int, default=768)
    ap.add_argument("--h", type=int, default=3072)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bn", type=int, nargs="+", default=[0],
                    help="tile widths to force in turn (0: the plan's own)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_profile needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for m in args.m:
        for bn in args.bn:
            print(json.dumps({"card": card, "forced_bn": bn or None,
                              **breakdown(m, args.c, args.h,
                                          iters=args.iters,
                                          bn=bn or None)}))


if __name__ == "__main__":
    main()
