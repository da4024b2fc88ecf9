"""Where a kernel's time goes: device time of each of its launches.

    python -m semireward_tpu_torch.k3_profile [--m 4776 6144] [--iters 20]
    python -m semireward_tpu_torch.k3_profile --c 384 --h 1536 --m 6168
    python -m semireward_tpu_torch.k3_profile --flash

For each row count M (C 768 / H 3072 by default: K3; a width K1 takes, such
as ViT-S's 384 / 1536: K1; bf16, seeded inputs) runs the kernel's forward
and backward ``iters`` times under ``torch.profiler`` and prints one JSON
line: the plan (``ops/fused_mlp.py:blocked_plan``), the device microseconds
per call of every kernel (F1 ``k*_fwd_up``, F2 ``k*_fwd_down``; B1
``k*_bwd_dh``, B2 ``k*_bwd_dx``, B3 ``k*_bwd_dw``, ``k*_bwd_colsum``,
``k*_bwd_reduce``, with ``k1_`` or ``k3_`` before each) with its TFLOP/s,
and the forward and backward times by CUDA events, whose excess over the
kernels' sum is the host's share. ``--flash`` does the same for K2, flash
attention (``k2_fwd``, ``k2_bwd_dq``, ``k2_bwd_dkv``), as the training step
calls it, at the ViT-S, HuBERT-base and BERT-base train shapes, with the
launches and the host's time to issue a call (:func:`flash_breakdown`).
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time
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


# K2 at the main path's train shapes: (B, N, H, key bias, dropout)
FLASH_SHAPES = {"vit": (24, 257, 6, False, 0.0),
                "hubert": (24, 199, 12, False, 0.1),
                "bert": (12, 512, 12, True, 0.1)}
# the products each K2 kernel computes, in N x N x 64 products
_FLASH_PRODUCTS = {"k2_fwd": 2, "k2_bwd_dq": 3, "k2_bwd_dkv": 4}


def _device_us(fn, iters):
    """-> ({kernel: device us a call}, kernels launched a call) of ``fn``
    under the profiler, after a warm-up cycle of ``iters`` calls: without
    one, a window this short can lose kernels while the tracer starts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    us, n = defaultdict(float), 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        found = re.search(r"(k2_\w+?)_kernel", e.name)
        us[found.group(1) if found else e.name] += (e.time_range.end
                                                    - e.time_range.start)
    return {k: v / iters for k, v in us.items()}, n / iters


def _host_us(fn, iters, runs=5):
    """Host microseconds to issue one call, back to back with no sync (the
    launch queue does not fill in ``iters`` calls); the median of ``runs``
    runs, as the host's speed drifts."""
    per_call = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e6 / iters)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def flash_breakdown(B: int, N: int, H: int, bias: bool = False,
                    rate: float = 0.0, iters: int = 20) -> dict:
    """K2 as a training step calls it: the public ``flash_attention`` on
    seeded bf16 [B, N, H, 64] inputs that need gradients (a padding bias on
    some rows with ``bias``; under dropout the forward writes its keep
    bits), and its backward through autograd. For each: device us a call
    of each kernel (TFLOP/s of the products each K2 kernel computes) and the
    launches a call under the profiler; CUDA-event ms a call, back to back,
    and its excess over the device us (the host's share: gaps the card
    waits); and the host us to issue a call. It calls nothing but
    ``flash_attention``, so it measures an older checkout as well: ``cd
    <checkout> && PYTHONPATH=. python <this file> --flash``."""
    from semireward_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, N, H, 64, generator=g).to(dev,
                                                           torch.bfloat16)
                   for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    mask = None
    if bias:
        lens = torch.randint(N // 4, N + 1, (B,), generator=g)
        mask = torch.where(torch.arange(N)[None, :] < lens[:, None], 0.0,
                           -1e9)[:, None, None, :].to(dev)
    seed = torch.tensor([20240601], dtype=torch.int32, device=dev)

    def fwd():
        return A.flash_attention(q, k, v, mask, rate, seed if rate else None)

    out = fwd()

    def bwd():
        return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)

    for _ in range(3):
        fwd(), bwd()
    flop = 2.0 * B * H * N * N * 64
    res = {"kernel": "flash_attention", "B": B, "N": N, "H": H,
           "bias": bias, "dropout": rate, "kernels": {}}
    for side, fn in (("fwd", fwd), ("bwd", bwd)):
        us, n = _device_us(fn, iters)
        for name, t in sorted(us.items()):
            if name not in _FLASH_PRODUCTS:  # the public path's other launches
                name = f"{side}: {name[:60]}"
            res["kernels"][name] = {
                "us": t, "tflops": (_FLASH_PRODUCTS[name] * flop / t / 1e6
                                    if name in _FLASH_PRODUCTS else None)}
        dev_us = sum(us.values())
        event_ms = _events_ms(fn, iters)
        res.update({f"{side}_device_us": dev_us, f"{side}_event_ms": event_ms,
                    f"{side}_host_share_us": event_ms * 1e3 - dev_us,
                    f"{side}_host_us": _host_us(fn, iters),
                    f"{side}_launches": n})
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[4776, 6144])
    ap.add_argument("--c", type=int, default=768)
    ap.add_argument("--h", type=int, default=3072)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bn", type=int, nargs="+", default=[0],
                    help="tile widths to force in turn (0: the plan's own)")
    ap.add_argument("--flash", action="store_true",
                    help="K2 at the three train shapes instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_profile needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.flash:
        for name, shape in FLASH_SHAPES.items():
            print(json.dumps({"card": card, "shape": name,
                              **flash_breakdown(*shape, iters=args.iters)}))
        return
    for m in args.m:
        for bn in args.bn:
            print(json.dumps({"card": card, "forced_bn": bn or None,
                              **breakdown(m, args.c, args.h,
                                          iters=args.iters,
                                          bn=bn or None)}))


if __name__ == "__main__":
    main()
