"""The port's Hopper kernels against their plain PyTorch versions on the
card. Imports no JAX, so it runs on a CUDA machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Without a card every test here skips."""
import dataclasses
import glob
import math
import os

import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from semireward_tpu_torch.ops import attention as A
from semireward_tpu_torch.ops import fused_mlp as F


def _close(got, want, rel, floor=0.0):
    """max|got - want| <= rel * max(max|want|, floor)."""
    scale = max(float(np.abs(want).max()), floor) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    """The dispatch on the card: K1 widths go to K1, every other C that is
    a multiple of 64 to K3 (C 768 / H 3072, DINOv2 ViT-L/14's 1024 / 4096,
    448, 64), and a width neither takes (C 100) runs as two dense layers,
    counted; a kernel refuses a dtype it does not take."""
    x = torch.zeros(8, 100, device=cuda_device, dtype=torch.bfloat16)
    w1 = torch.zeros(400, 100, device=cuda_device, dtype=torch.bfloat16)
    w2 = torch.zeros(100, 400, device=cuda_device, dtype=torch.bfloat16)
    b1 = torch.zeros(400, device=cuda_device)
    b2 = torch.zeros(100, device=cuda_device)
    F.reset_launches()
    out = F.fused_mlp(x, w1, b1, w2, b2)       # C = 100: neither kernel
    assert out.shape == (8, 100) and F.launches["fused_mlp_dense"] == 1
    assert F.launches["fused_mlp_blocked_fwd"] == F.launches["fused_mlp_fwd"] == 0
    with pytest.raises(ValueError, match="bfloat16"):       # no f32 kernel
        F.fused_mlp(torch.zeros(8, 128, device=cuda_device),
                    torch.zeros(256, 128, device=cuda_device), b1[:256],
                    torch.zeros(128, 256, device=cuda_device),
                    torch.zeros(128, device=cuda_device))
    # the route asks the kernel libraries
    assert F.route(384, 1536, cuda_device) == "full"        # ViT-S: K1
    assert F.route(192, 768, cuda_device) == "full"         # ViT-Ti: K1
    assert F.route(448, 1792, cuda_device) == "blocked"     # past K1's 384
    assert F.route(768, 3072, cuda_device) == "blocked"     # ViT-B/BERT: K3
    assert F.route(768, 3072, cuda_device, block_h=768) == "blocked"
    assert F.route(1024, 4096, cuda_device) == "blocked"    # DINOv2 ViT-L/14
    assert F.route(384, 1536, cuda_device, block_h=768) == "blocked"
    assert F.route(64, 256, cuda_device) == "blocked"
    assert F.route(100, 400, cuda_device) == "dense"
    with pytest.raises(ValueError, match="must divide"):
        F.route(768, 3072, cuda_device, block_h=1000)


def _mlp_inputs(dev, m, c, h, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(m, c, generator=g).to(dev, torch.bfloat16),
            (torch.randn(h, c, generator=g) * 0.03).to(dev, torch.bfloat16),
            (torch.randn(h, generator=g) * 0.1).to(dev),
            (torch.randn(c, h, generator=g) * 0.03).to(dev, torch.bfloat16),
            (torch.randn(c, generator=g) * 0.1).to(dev),
            torch.randn(m, c, generator=g).to(dev, torch.bfloat16))


def _check_kernels(dev, m, c, h, kernel, plan=None):
    """K1 (``kernel`` "full") or K3 ("blocked") forward and backward against
    the plain version (bf16: 1e-2 of the largest magnitude; f32 bias grads:
    1e-3); the backward bit-equal across two launches."""
    fwd, bwd = ((F.kernel_fwd, F.kernel_bwd) if kernel == "full"
                else (F.kernel_blocked_fwd, F.kernel_blocked_bwd))
    x, w1, b1, w2, b2, gy = _mlp_inputs(dev, m, c, h)
    pairs = [(fwd(x, w1, b1, w2, b2, plan=plan),
              F.plain_fwd(x, w1, b1, w2, b2), 1e-2)]
    grads = bwd(x, w1, b1, w2, gy, plan=plan)
    for k, p, name in zip(grads, F.plain_bwd(x, w1, b1, w2, gy),
                          ("dx", "dw1", "dw2", "db1", "db2")):
        pairs.append((k, p, 1e-3 if name.startswith("db") else 1e-2))
    again = bwd(x, w1, b1, w2, gy, plan=plan)
    torch.cuda.synchronize()
    for k, p, rel in pairs:
        _close(k.float().cpu().numpy(), p.float().cpu().numpy(), rel)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,h", [(100, 128, 256), (129, 192, 768),
                                   (6168, 384, 1536), (2056, 384, 1536),
                                   (14392, 384, 1536), (8224, 384, 1536),
                                   (55320, 384, 1536), (18440, 384, 1536)])
def test_kernel_matches_plain_on_the_card(cuda_device, m, c, h):
    """K1 (F1 + F2; B1 + B2 + B3 + reduction) against the plain version on
    the plan the wrapper picks: a small ragged shape, ViT-Ti's width with
    one row past a 128-row tile, the ViT-S train shape (M 24*257),
    SRPseudoLabel's, MixMatch's and ReMixMatch's (forwards of 8*257 rows),
    CRMatch's one forward of 56*257 rows, DeFixMatch's and CoMatch's of
    32*257, and SimMatch's on the STL-10 YAML (96 px: N 2305), its
    forward of 24*2305 rows and its EMA teacher's of 8*2305."""
    _check_kernels(cuda_device, m, c, h, "full")


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,h,bn,splits", [(300, 384, 1536, 128, 1),
                                             (300, 384, 1536, 192, 2),
                                             (300, 256, 1536, 256, 3),
                                             (200, 320, 1568, 192, 4)])
def test_full_kernels_every_width_and_split_on_the_card(cuda_device, m, c, h,
                                                        bn, splits):
    """K1 on plans the wrapper does not pick: F2, B2 and B3 at tile width
    128, 192 and 256 (F1 and B1 run ping-pong at 128 and 64), B3 with its K
    split into 1-4 f32 partials, widths C 256 and 320, and an H that is a
    multiple of 32 but not of a tile (partial column tiles, a partial K
    step)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = F.blocked_plan(m, c, h, sms, bn=bn, dw_splits=splits,
                          kernel="full")
    assert plan["dw"]["splits"] == splits
    _check_kernels(cuda_device, m, c, h, "full", plan)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4776, 6144, 8192, 77, 1, 129])
def test_blocked_kernels_match_plain_on_the_card(cuda_device, m):
    """K3 (F1 + F2; B1 + B2 + B3 + reduction) against the plain version at
    the HuBERT-base train shape (M 24*199), the BERT-base one (M 12*512),
    CoMatch's on BERT-base (M 16*512) and small ragged M (129: one row
    past a 128-row tile), C 768, H 3072, on the plan the wrapper picks."""
    _check_kernels(cuda_device, m, 768, 3072, "blocked")


@pytest.mark.cuda
@pytest.mark.parametrize("m,h,bn,splits", [(300, 3072, 128, 1),
                                           (300, 3072, 256, 3),
                                           (129, 3104, 256, 2)])
def test_blocked_kernels_every_width_and_split_on_the_card(cuda_device, m, h,
                                                           bn, splits):
    """K3 on plans the wrapper does not pick at the model shapes: every GEMM
    at tile width 128, then 256, B3 with its K split into f32 partials, and
    an H that is a multiple of 32 but not of a tile (partial column tiles,
    a partial K step)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = F.blocked_plan(m, 768, h, sms, bn=bn, dw_splits=splits)
    assert plan["dw"]["splits"] == splits
    _check_kernels(cuda_device, m, 768, h, "blocked", plan)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,h", [(12336, 1024, 4096), (4112, 1024, 4096),
                                   (1, 1024, 4096), (129, 1024, 4096),
                                   (2749, 512, 2048), (300, 448, 1792),
                                   (100, 64, 256), (129, 2304, 512)])
def test_blocked_kernels_match_plain_at_every_width_on_the_card(cuda_device,
                                                                m, c, h):
    """K3 at the widths it takes besides 768, on the plan the wrapper
    picks: DINOv2 ViT-L/14's (C 1024, H 4096) at its train shape (16 + 16
    images with ``use_cat``: 48 * 257 rows), its eval batch (16 * 257) and
    M 1 and 129; C 512 at a ragged M; C 448 (a half-empty 256-wide column
    tile) and 64; C 2304, past the 2048 columns that one block of the
    column-sum kernel covers in one pass."""
    _check_kernels(cuda_device, m, c, h, "blocked")


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [128, 256])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_blocked_kernels_every_width_and_split_at_c1024_on_the_card(
        cuda_device, bn, splits):
    """K3 at C 1024, H 4096 on every tile width and B3 K split, at a
    ragged M."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = F.blocked_plan(1300, 1024, 4096, sms, bn=bn, dw_splits=splits)
    assert plan["dw"]["splits"] == splits
    _check_kernels(cuda_device, 1300, 1024, 4096, "blocked", plan)


def _dinov2_pair(cuda_device, name, num_classes):
    """The same DINOv2 net twice on the card (bf16): through K2 + K3 and
    through the plain attention and MLP."""
    from semireward_tpu_torch.models import get_net_builder

    nets = [get_net_builder(name)(
        num_classes=num_classes, device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(0),
        use_fused_mlp=k, use_flash=k) for k in (True, False)]
    nets[1].load_state_dict(nets[0].state_dict())
    with torch.no_grad():  # LayerScale off its 1e-5, so the blocks matter
        for net in nets:
            for blk in net.blocks:
                blk.ls1.fill_(0.5)
                blk.ls2.fill_(0.5)
    return nets


def _cosine(a, b):
    a, b = (torch.cat([t.float().flatten() for t in g]) for g in (a, b))
    return float((a @ b) / (a.norm() * b.norm()))


@pytest.mark.cuda
def test_dinov2_vitl14_step_on_the_card_through_k2_and_k3(cuda_device):
    """``dinov2_vitl14`` (C 1024, 16 heads, N 257) on the card: logits
    through K2 + K3 (K3 at C 1024) within 2% of the plain path's on the
    same weights, and one train step's gradients at cosine >= 0.99 of the
    plain path's, one forward and one backward of each kernel a block."""
    fused, plain = _dinov2_pair(cuda_device, "dinov2_vitl14", 10)
    x = torch.randn(4, 224, 224, 3, device=cuda_device,
                    generator=torch.Generator(device=cuda_device
                                              ).manual_seed(1))
    F.reset_launches()
    A.reset_launches()
    grads = []
    for net in (fused, plain):
        out = net(x, train=True)
        loss = out["logits"].float().logsumexp(-1).mean()
        grads.append(torch.autograd.grad(loss, list(net.parameters())))
        if net is fused:
            logits = out["logits"].detach().float().cpu().numpy()
        else:
            _close(logits, out["logits"].detach().float().cpu().numpy(),
                   2e-2)
    torch.cuda.synchronize()
    assert F.launches["fused_mlp_blocked_fwd"] == 24
    assert F.launches["fused_mlp_blocked_bwd"] == 24
    assert F.launches["fused_mlp_dense"] == 0
    assert A.launches == {"flash_attention_fwd": 24,
                          "flash_attention_bwd": 24}
    assert all(bool(torch.isfinite(g).all()) for g in grads[0])
    assert _cosine(*grads) >= 0.99


@pytest.mark.cuda
def test_dinov2_vitb14_regression_step_on_the_card(cuda_device):
    """PseudoLabel's regression loss on ``dinov2_vitb14`` with one output
    (three forwards: labeled, noisy and clean unlabeled) through K2 + K3
    against the plain path on the same weights and noise: losses within
    2%, gradients at cosine >= 0.99; K3 and K2 forwards 3 a block, their
    backwards 2."""
    from semireward_tpu_torch.algorithms.base import StepCtx
    from semireward_tpu_torch.config import get_config
    from semireward_tpu_torch.registry import ALGORITHMS

    cfg = get_config(algorithm="pseudolabel", num_classes=1)
    assert cfg.is_regression
    alg = ALGORITHMS.get("pseudolabel")(cfg, {}, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    batch = {"x_lb": torch.randn(4, 224, 224, 3, device=cuda_device,
                                 generator=g),
             "x_ulb_w": torch.randn(4, 224, 224, 3, device=cuda_device,
                                    generator=g),
             "y_lb": torch.rand(4, device=cuda_device, generator=g) * 100}
    outs, grads = [], []
    F.reset_launches()
    A.reset_launches()
    for net in _dinov2_pair(cuda_device, "dinov2_vitb14", 1):
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        out = alg.loss(StepCtx(model=net, batch=batch, algo_state=(),
                               generator=gen, step=1000, sr_state=None,
                               ema=None))
        outs.append([float(out.sup_loss), float(out.unsup_loss)])
        grads.append(torch.autograd.grad(out.total_loss,
                                         list(net.parameters())))
        if len(outs) == 1:
            launches = {**F.launches, **A.launches}
    torch.cuda.synchronize()
    _close(np.array(outs[0]), np.array(outs[1]), 2e-2)
    assert outs[0][1] > 0.0 and all(map(math.isfinite, outs[0]))
    assert _cosine(*grads) >= 0.99
    assert launches == {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0,
                        "fused_mlp_blocked_fwd": 36,
                        "fused_mlp_blocked_bwd": 24, "fused_mlp_dense": 0,
                        "flash_attention_fwd": 36,
                        "flash_attention_bwd": 24}


@pytest.mark.cuda
def test_fused_mlp_autograd_launches_the_blocked_kernels(cuda_device):
    """fused_mlp at C 768 / H 3072 on CUDA tensors launches K3's forward
    once and its backward once, and gives the plain version's gradients."""
    x, w1, b1, w2, b2, gy = _mlp_inputs(cuda_device, 300, 768, 3072, seed=1)
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    F.reset_launches()
    F.fused_mlp(*leaves).backward(gy)
    torch.cuda.synchronize()
    assert F.launches == {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0,
                          "fused_mlp_blocked_fwd": 1,
                          "fused_mlp_blocked_bwd": 1, "fused_mlp_dense": 0}
    dx, dw1, dw2, db1, db2 = F.plain_bwd(x, w1, b1, w2, gy)
    for got, want, rel in ((leaves[0].grad, dx, 1e-2), (leaves[1].grad, dw1, 1e-2),
                           (leaves[2].grad, db1, 1e-3), (leaves[3].grad, dw2, 1e-2),
                           (leaves[4].grad, db2, 1e-3)):
        _close(got.float().cpu().numpy(), want.float().cpu().numpy(), rel)


@pytest.mark.cuda
def test_vit_base_steps_on_the_card_through_k3(cuda_device):
    """vit_base_patch16_224 (C 768, H 3072) builds on the card with the
    fused MLP and takes one train step through K3."""
    from semireward_tpu_torch.models import get_net_builder

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = get_net_builder("vit_base_patch16_224")(
        num_classes=10, device=cuda_device, generator=gen, use_fused_mlp=True)
    x = torch.randn(2, 224, 224, 3, device=cuda_device)
    F.reset_launches()
    out = model(x, train=True, generator=gen)
    loss = out["logits"].float().logsumexp(-1).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    assert F.launches["fused_mlp_blocked_fwd"] == 12
    assert F.launches["fused_mlp_blocked_bwd"] == 12
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
def test_vat_step_on_the_card_through_k1_and_k2(cuda_device):
    """A VAT step on vit_tiny_patch2_32 with the fused MLP and flash
    attention: four forwards and four backwards a layer (the power
    iteration's ``autograd.grad`` runs the backward kernels), finite."""
    from semireward_tpu_torch.algorithms import vat  # noqa: F401
    from semireward_tpu_torch.config import get_config
    from semireward_tpu_torch.core.step import (init_train_state,
                                                make_train_step)
    from semireward_tpu_torch.models import get_net_builder
    from semireward_tpu_torch.ops import attention as A
    from semireward_tpu_torch.registry import ALGORITHMS

    cfg = get_config(algorithm="vat", net="vit_tiny_patch2_32",
                     num_classes=10, batch_size=4, optim="AdamW", lr=5e-4)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    builder = get_net_builder("vit_tiny_patch2_32")
    model = builder(num_classes=10, device=cuda_device, generator=gen,
                    use_fused_mlp=True, use_flash=True)
    alg = ALGORITHMS.get("vat")(cfg, {}, cuda_device)
    state = init_train_state(cfg, alg, model, builder, gen)
    batch = {"x_lb": torch.randn(4, 32, 32, 3, device=cuda_device),
             "x_ulb_w": torch.randn(4, 32, 32, 3, device=cuda_device),
             "y_lb": torch.randint(0, 10, (4,), device=cuda_device)}
    F.reset_launches()
    A.reset_launches()
    metrics = make_train_step(cfg, alg)(state, batch, gen)
    torch.cuda.synchronize()
    assert F.launches["fused_mlp_fwd"] == F.launches["fused_mlp_bwd"] == 48
    assert (A.launches["flash_attention_fwd"]
            == A.launches["flash_attention_bwd"] == 48)
    assert all(math.isfinite(float(v)) for v in metrics.values())


@pytest.mark.cuda
def test_vit_tiny_steps_on_the_card_through_k1(cuda_device):
    """vit_tiny_patch2_32 (C 192, H 768) builds on the card with the fused
    MLP and takes one train step through K1."""
    from semireward_tpu_torch.models import get_net_builder

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = get_net_builder("vit_tiny_patch2_32")(
        num_classes=10, device=cuda_device, generator=gen, use_fused_mlp=True)
    x = torch.randn(4, 32, 32, 3, device=cuda_device)
    F.reset_launches()
    out = model(x, train=True, generator=gen)
    loss = out["logits"].float().logsumexp(-1).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    assert F.launches["fused_mlp_fwd"] == 12
    assert F.launches["fused_mlp_bwd"] == 12
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("train,frozen", [(True, False), (True, True),
                                          (False, False)])
def test_flax_batchnorm_on_the_card_matches_the_cpu(cuda_device, train,
                                                    frozen):
    """The flax-semantics BatchNorm (models/batchnorm.py) on the card
    against its CPU result on the same f32 input: output within 1e-5 of its
    magnitude, running statistics within 1e-6 (updated in training, left
    as they were frozen or in eval); the bf16 output on the card within 1%
    (one bf16 rounding is 0.4%)."""
    from semireward_tpu_torch.models.batchnorm import BatchNorm, frozen_bn

    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 32, 16, 16, generator=g) * 3 + 1
    scale = torch.rand(32, generator=g) + 0.5
    shift = torch.randn(32, generator=g)
    outs, stats = [], []
    for dev in (torch.device("cpu"), cuda_device):
        bn = BatchNorm(32, momentum=0.9).to(dev)
        with torch.no_grad():
            bn.weight.copy_(scale)
            bn.bias.copy_(shift)
            bn.running_var.fill_(2.0)
        with torch.no_grad():
            if frozen:
                with frozen_bn(bn):
                    outs.append(bn(x.to(dev), train=train).cpu())
            else:
                outs.append(bn(x.to(dev), train=train).cpu())
            stats.append([bn.running_mean.cpu().clone(),
                          bn.running_var.cpu().clone()])
            if dev.type == "cuda":
                half = bn(x.to(dev, torch.bfloat16), train=train)
                assert half.dtype == torch.bfloat16
    _close(outs[1].numpy(), outs[0].numpy(), 1e-5)
    for a, b in zip(stats[1], stats[0]):
        _close(a.numpy(), b.numpy(), 1e-6)
    moved = not torch.equal(stats[0][1], torch.full((32,), 2.0))
    assert moved == (train and not frozen)
    _close(half.float().cpu().numpy(), outs[0].numpy(), 1e-2)


@pytest.mark.cuda
def test_wrn_steps_on_the_card(cuda_device):
    """wrn_28_2 (bf16 convs on cuDNN, f32 parameters and statistics)
    builds on the card and takes one train step; its running statistics
    move in train mode and eval runs on them. The dead bn1s' scale and
    bias take no gradient (allow_unused)."""
    from semireward_tpu_torch.models import get_net_builder

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = get_net_builder("wrn_28_2")(num_classes=10, device=cuda_device,
                                        generator=gen)
    x = torch.randn(16, 32, 32, 3, device=cuda_device)
    before = model.bn1.running_mean.clone()
    out = model(x, train=True)
    loss = out["logits"].float().logsumexp(-1).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    assert not torch.equal(before, model.bn1.running_mean)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert model.bn1.running_mean.dtype == torch.float32
    ev = model(x, train=False)
    assert bool(torch.isfinite(ev["logits"]).all())
    assert ev["feat"].dtype == torch.float32 and ev["feat"].shape == (16, 128)


def _attn_inputs(dev, B, N, H, d, pad, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, N, H, d, generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    lens = torch.full((B,), N)
    lens[0] = max(N - pad, 1)
    keep = torch.arange(N)[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, -1e9)[:, None, None, :].to(dev)
    return q, k, v, do, bias


def _check_flash(dev, B, N, H, bias, rate, pad=37):
    """K2 forward (out, lse, keep bits) and backward (dq, dk, dv from the
    forward's bits, delta computed in the dq kernel) against the plain
    version on the same bf16 inputs. The kernels round P, dS and P^T to bf16
    before their products: bf16 outputs within 1% of max|plain|; lse (f32)
    within 1e-5 of its magnitude; the bits equal pack_keep_bits of
    attention_keep_mask. dq and dk sum p * (dp - delta), a difference of two
    f32 dot products taken in another order than the plain version's; at N
    1 (a softmax over one key) the plain dq and dk are exactly 0, so their
    scale floors at 1e-3 of max|plain dv|: f32 rounding of that difference
    (~1e-7 of |dp|) passes, a wrong gradient does not."""
    d = 64
    q, k, v, do, kb = _attn_inputs(dev, B, N, H, d, pad=pad)
    kb = A._key_bias_of(kb, B, H, N) if bias else None
    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    out, lse, bits = A.kernel_fwd(q, k, v, kb, seed, rate, keep_bits=True)
    p_out, p_lse = A.plain_fwd(q, k, v, kb, seed, rate)
    grads = A.kernel_bwd(q, k, v, kb, seed, rate, do, lse, out, bits)
    p_grads = A.plain_bwd(q, k, v, kb, seed, rate, do, lse,
                          A.delta_of(do, out))
    torch.cuda.synchronize()
    _close(out.float().cpu().numpy(), p_out.float().cpu().numpy(), 1e-2)
    _close(lse.cpu().numpy(), p_lse.cpu().numpy(), 1e-5)
    floor = 1e-3 * float(p_grads[2].float().abs().max())
    for a, b in zip(grads, p_grads):
        _close(a.float().cpu().numpy(), b.float().cpu().numpy(), 1e-2, floor)
    if rate:
        want = A.pack_keep_bits(A.attention_keep_mask(
            seed, B * H, N, A.padded_len(N), A.keep_threshold(rate)))
        assert torch.equal(bits, want), int((bits != want).sum())
    else:
        assert bits is None


@pytest.mark.cuda
@pytest.mark.parametrize("N", [200, 512, 77, 130, 1, 63, 65, 127, 129, 1000])
@pytest.mark.parametrize("bias,rate", [(False, 0.0), (True, 0.0), (True, 0.1)])
def test_flash_kernels_match_plain_on_the_card(cuda_device, N, bias, rate):
    """K2 against its plain version at B 2, H 3: ragged N (1, 63, 65, 77,
    127, 129, 130, 200: partial 64-row tiles, a consumer with no rows), 512
    and 1000 (the shared-memory rings wrap), without bias, with the key
    bias, with bias and dropout."""
    _check_flash(cuda_device, 2, N, 3, bias, rate, pad=min(37, N - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,bias,rate", [
    (24, 257, 6, False, 0.0),    # ViT-S train
    (8, 257, 6, False, 0.0),     # ViT-S, SRPseudoLabel's separate forwards
    (56, 257, 6, False, 0.0),    # ViT-S, CRMatch's one forward
    (32, 257, 6, False, 0.0),    # ViT-S, DeFixMatch's one forward
    (24, 199, 12, False, 0.1),   # HuBERT-base train
    (12, 512, 12, True, 0.1),    # BERT-base train
    (16, 512, 12, True, 0.1),    # BERT-base, CoMatch's one forward
    (24, 2305, 6, False, 0.0),   # ViT-S at 96 px, SimMatch on STL-10
    (12, 512, 12, True, 0.0),    # BERT-base eval (bias only)
])
def test_flash_kernels_match_plain_at_the_model_shapes(cuda_device, B, N, H,
                                                      bias, rate):
    """K2 against its plain version at the main path's shapes."""
    _check_flash(cuda_device, B, N, H, bias, rate)


@pytest.mark.cuda
@pytest.mark.parametrize("N,rate", [(512, 0.1), (199, 0.1), (257, 0.0)])
def test_flash_backward_gives_the_same_bits_twice(cuda_device, N, rate):
    """dq, dk and dv are bit-equal across two launches (one writer per
    output, no atomics)."""
    B, H = 4, 3
    q, k, v, do, kb = _attn_inputs(cuda_device, B, N, H, 64, pad=40)
    kb = A._key_bias_of(kb, B, H, N)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda_device)
    out, lse, bits = A.kernel_fwd(q, k, v, kb, seed, rate, keep_bits=True)
    first = A.kernel_bwd(q, k, v, kb, seed, rate, do, lse, out, bits)
    again = A.kernel_bwd(q, k, v, kb, seed, rate, do, lse, out, bits)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [200, 512])
def test_flash_dropout_stream_is_bit_exact_on_the_card(cuda_device, N):
    """The forward kernel's keep mask read out exactly: q = k = 0 makes
    every score equal; a key bias of -1e9 outside a window of 64 keys leaves
    p = 1/64 there and exactly 0 elsewhere; v one-hot per window key puts
    keep[q, key] in output column key - window start. Zero against non-zero
    is exact, so the mask is compared bit for bit with
    attention_keep_mask."""
    B, H, d = 2, 3, 64
    z = torch.zeros(B, N, H, d, device=cuda_device, dtype=torch.bfloat16)
    seed = torch.tensor([20240601], dtype=torch.int32, device=cuda_device)
    want = A.attention_keep_mask(seed, B * H, N, A.padded_len(N),
                                 A.keep_threshold(0.1)).cpu()
    got = torch.zeros(B * H, N, N, dtype=torch.bool)
    for w in range(0, N, 64):
        width = min(64, N - w)
        v = torch.zeros_like(z)
        v[:, w:w + width, :, :width] = torch.eye(width).to(v)[:, None, :]
        keys = torch.arange(N, device=cuda_device)
        kb = torch.where((keys >= w) & (keys < w + width), 0.0, -1e9)
        kb = kb.expand(B * H, N).contiguous()
        out, _, _ = A.kernel_fwd(z, z, v, kb, seed, 0.1)
        got[:, :, w:w + width] = (out[..., :width] != 0).permute(
            0, 2, 1, 3).reshape(B * H, N, width).cpu()
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    assert abs(want.float().mean().item() - 0.9) < 0.01


def _backward_mask_readout(dev, B, N, H, which):
    """The keep mask as the backward kernels apply it, read out exactly
    from bits packed by the plain pack_keep_bits. lse = 0 and q.k = 0 make
    every p = 1; out = 0 makes delta = 0. dq: K one-hot over a 64-key
    window, V = dO = e0, so dp = 1, ds = keep / keep_prob and dq[q, c] is
    keep[q, w + c] * scale / keep_prob. dv: K = V = 0, dO one-hot over a
    64-query window, so dv[key, c] is keep[w + c, key] / keep_prob."""
    d = 64
    seed = torch.tensor([424242], dtype=torch.int32, device=dev)
    keep = A.attention_keep_mask(seed, B * H, N, A.padded_len(N),
                                 A.keep_threshold(0.1))
    bits = A.pack_keep_bits(keep)
    z = torch.zeros(B, N, H, d, device=dev, dtype=torch.bfloat16)
    lse = torch.zeros(B * H, N, device=dev)
    e0 = z.clone()
    e0[..., 0] = 1
    got = torch.zeros_like(keep)
    for w in range(0, N, 64):
        width = min(64, N - w)
        one_hot = z.clone()
        one_hot[:, w:w + width, :, :width] = torch.eye(width, device=dev).to(
            z)[:, None, :]
        if which == "dq":
            dq, _, _ = A.kernel_bwd(z, one_hot, e0, None, seed, 0.1, e0, lse,
                                    z, bits)
            got[:, :, w:w + width] = (dq[..., :width] != 0).permute(
                0, 2, 1, 3).reshape(B * H, N, width)
        else:
            _, _, dv = A.kernel_bwd(z, z, z, None, seed, 0.1, one_hot, lse,
                                    z, bits)
            got[:, w:w + width, :] = (dv[..., :width] != 0).permute(
                0, 2, 3, 1).reshape(B * H, width, N)
    torch.cuda.synchronize()
    assert torch.equal(got, keep), int((got != keep).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("N", [512, 199, 65])
@pytest.mark.parametrize("which", ["dq", "dv"])
def test_flash_backward_applies_the_keep_bits_exactly(cuda_device, N, which):
    """The dq and dk/dv kernels' dropout masks, read out bit for bit."""
    _backward_mask_readout(cuda_device, 2, N, 3, which)


@pytest.mark.cuda
def test_flash_autograd_uses_the_kernels(cuda_device):
    """flash_attention on CUDA tensors launches the forward once and the
    backward once, and refuses a bias that is not key-only (no plain
    route on the card)."""
    q, k, v, do, kb = _attn_inputs(cuda_device, 2, 128, 2, 64, pad=9)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    A.reset_launches()
    out = A.flash_attention(q, k, v, bias=kb, dropout_rate=0.1,
                            dropout_seed=torch.tensor(7, device=cuda_device))
    out.backward(do)
    torch.cuda.synchronize()
    assert A.launches == {"flash_attention_fwd": 1, "flash_attention_bwd": 1}
    full = torch.zeros(2, 1, 128, 128, device=cuda_device)
    with pytest.raises(ValueError, match="key-only"):
        A.flash_attention(q, k, v, bias=full)
    assert A.launches["flash_attention_fwd"] == 1
    with pytest.raises(ValueError, match="keep bits"):
        A.kernel_bwd(q.detach(), k.detach(), v.detach(), None,
                     torch.tensor([7], dtype=torch.int32, device=cuda_device),
                     0.1, do, torch.zeros(4, 128, device=cuda_device),
                     out.detach(), None)


@pytest.mark.cuda
def test_headline_trainer_resumes_bit_equal_on_the_card(cuda_device,
                                                        tmp_path):
    """The headline config's Trainer (SRFlexMatch, ViT-S/2-32 through K1
    and K2) trains 12 steps into stage 2 and writes its checkpoints; a
    second Trainer resumes from ``latest_model.ckpt`` as the CLI does. Every
    leaf of the state is bit-equal on the card, the CUDA generator's state
    included, and so is the state after one more step of each on the same
    raw batch."""
    from semireward_tpu_torch.core.checkpoint import LATEST
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.profile_step import HEADLINE, synthetic_config
    from semireward_tpu_torch.train import build_trainer

    def cfg(run, **kw):
        return synthetic_config(HEADLINE, {
            "num_eval_iter": 12, "num_log_iter": 4, "start_timing": 4,
            "N_k": 4, "synthetic_test": 32,
            "save_dir": str(tmp_path / run), **kw})

    a = Trainer(cfg("a"), device=cuda_device)
    a.train(num_iters=12)
    latest = tmp_path / "a" / a.cfg.save_name / LATEST
    b = build_trainer(cfg("b", resume=True, load_path=str(latest)),
                      device=cuda_device)
    assert a.generator.device.type == "cuda" and b.state.step == 12

    def same(x, y):
        sx, sy = x.state_dict(), y.state_dict()
        assert sorted(sx) == sorted(sy)
        for k in sx:
            assert sx[k].device == sy[k].device, k
            assert torch.equal(sx[k], sy[k]), k

    same(a.state, b.state)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    raw = next(a._make_loader())
    for tr in (a, b):
        tr._step(tr.state, tr.make_batch(raw), tr.generator)
    torch.cuda.synchronize()
    same(a.state, b.state)


# ---------------------------------------------------------------------------
# writes at a repeated index keep the last row on the card
# ---------------------------------------------------------------------------

def _repeated(dev, seed=0, k=40, n=64, c=10):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, k, (n,), generator=g)
    assert len(idx.unique()) < n
    return (idx.to(dev), torch.randn(16, k, generator=g).to(dev),
            torch.randn(16, n, generator=g).to(dev),
            torch.randint(0, c, (n,), generator=g).to(dev),
            torch.randint(0, c, (k,), generator=g).to(dev),
            torch.softmax(4 * torch.randn(n, c, generator=g), -1).to(dev))


@pytest.mark.cuda
def test_repeated_index_writes_give_the_same_bits_on_the_card(cuda_device):
    """64 rows drawn from 40 (SimMatch's CIFAR-10-40 batch): the bank and
    label writes (``common.write_last``) and FlexMatch's
    ``selected_label`` give the same bits in two runs and the CPU's bits;
    ``class_similarity`` gives the same bits twice and is within 1e-6 of
    the CPU's. Then one SimMatch loss on a narrow WRN at those rows, twice
    with one seed: the banks bit-equal, the labels bank the CPU's and the
    memory bank within 1e-3 of the CPU's (float32 convolutions)."""
    from semireward_tpu_torch.algorithms import common as C
    from semireward_tpu_torch.algorithms import simmatch as SM

    def run(dev):
        idx, bank, cols, y, labels, probs = _repeated(dev)
        st = C.FlexState(torch.full((40,), -1, dtype=torch.long, device=dev),
                         torch.zeros(10, device=dev))
        flex, mask = C.flex_mask(st, probs, idx, 0.5, True)
        tp = torch.softmax(torch.randn(12, 40, generator=torch.Generator(
            ).manual_seed(1)), -1).to(dev)
        return {"bank": C.write_last(bank, 1, idx, cols),
                "labels": C.write_last(labels, 0, idx, y),
                "selected": flex.selected_label, "mask": mask,
                "acc": flex.classwise_acc,
                "agg": SM.class_similarity(tp, labels, 10)}

    a, b, cpu = run(cuda_device), run(cuda_device), run("cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
        if k != "agg":
            assert torch.equal(a[k].cpu(), cpu[k]), k
    _close(a["agg"].cpu().numpy(), cpu["agg"].numpy(), 1e-6)

    from semireward_tpu_torch.algorithms.base import StepCtx
    from semireward_tpu_torch.config import get_config
    from semireward_tpu_torch.models import wrn

    idx, *_ = _repeated("cpu")
    cfg = get_config(algorithm="simmatch", net="wrn_28_2", num_classes=10,
                     batch_size=64, uratio=1, num_train_iter=10, epoch=10,
                     img_size=16, compute_dtype="float32", proj_size=16,
                     da_len=2, p_cutoff=0.3)
    info = {"ulb_dest_len": 64, "lb_dest_len": 40}
    g = torch.Generator().manual_seed(3)
    x = {k: torch.randn(64, 16, 16, 3, generator=g)
         for k in ("x_lb", "x_ulb_w", "x_ulb_s")}
    y = torch.randint(0, 10, (64,), generator=g)

    def to(obj, dev):
        """A state of dataclasses of tensors on ``dev``."""
        if isinstance(obj, torch.Tensor):
            return obj.to(dev)
        return dataclasses.replace(obj, **{
            f.name: to(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})

    # the bank drawn once, on the CPU: the card's generator draws others
    state0 = SM.SimMatch(cfg, info, torch.device("cpu")).init_state()

    def loss(dev):
        alg = SM.SimMatch(cfg, info, torch.device(dev))
        model = alg.wrap_model(wrn.wrn_28_2(
            10, dtype=torch.float32, depth=10, widen_factor=1,
            generator=torch.Generator().manual_seed(0)),
            torch.Generator().manual_seed(0)).to(dev)
        batch = {**{k: v.to(dev) for k, v in x.items()}, "y_lb": y.to(dev),
                 "idx_lb": idx.to(dev)}
        out = alg.loss(StepCtx(model, batch, to(state0, dev), None, 3))
        return out.new_algo_state

    # float32 convolutions (cuDNN takes TF32 by default), so that the bank
    # can be held to the CPU's
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        s1, s2 = loss(cuda_device), loss(cuda_device)
    sc = loss("cpu")
    assert torch.equal(s1.mem_bank, s2.mem_bank)
    assert torch.equal(s1.labels_bank, s2.labels_bank)
    assert torch.equal(s1.labels_bank.cpu(), sc.labels_bank)
    _close(s1.mem_bank.cpu().numpy(), sc.mem_bank.numpy(), 1e-3)


@pytest.mark.cuda
def test_darp_and_daso_repeated_writes_give_the_same_bits(cuda_device):
    """DARP's ``pseudo_orig`` written at ``idx_ulb`` with repeats and
    DASO's queue written by a batch with more rows of a class than the
    ring holds: the same bits twice on the card, and the CPU's."""
    from semireward_tpu_torch.algorithms import common as C
    from semireward_tpu_torch.imb.daso import DASOState, enqueue

    def run(dev):
        idx, _, _, _, _, probs = _repeated(dev, seed=4, k=40, n=64)
        orig = torch.full((40, 10), 0.1, device=dev)
        g = torch.Generator().manual_seed(5)
        y = torch.tensor([0] * 7 + [1, 2, 1], device=dev)
        feats = torch.randn(10, 8, generator=g).to(dev)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        st = DASOState(bank=z(3, 3, 8), bank_ptr=z(3, dtype=torch.int32),
                       bank_cnt=z(3, dtype=torch.int32), prototypes=z(3, 8),
                       pl_counts_acc=z(3), pl_dist=z(3), probs_sim=z(4, 3))
        st = enqueue(enqueue(st, feats, y), feats.flip(0), y.flip(0))
        return {"pseudo_orig": C.write_last(orig, 0, idx, probs),
                "bank": st.bank, "ptr": st.bank_ptr, "cnt": st.bank_cnt,
                "protos": st.prototypes}

    a, b, cpu = run(cuda_device), run(cuda_device), run("cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k].cpu(), cpu[k]), k
    assert a["ptr"].tolist() == [(14 % 3), 4 % 3, 2 % 3]


@pytest.mark.cuda
@pytest.mark.parametrize("exclude_color", [True, False])
def test_augmentation_on_the_card_equals_the_cpu(cuda_device, exclude_color):
    """The weak and strong views of the golden orbit images (the ones the
    golden-learning checks train on) built on the card from the same draws
    as on the CPU: crop / flip gathers and the colour ops bit-equal; the
    geometric ops floor an affine map that the card may round one ulp
    apart, so at most 0.5% of the pixels may differ."""
    from semireward_tpu_torch.data.augment import pipeline as P
    from semireward_tpu_torch.data.datasets import make_synthetic_orbit

    (x, _), _, _ = make_synthetic_orbit(6, 32, 48, n_ulb=6, n_test=6)
    spec = P.AugmentSpec(crop_size=32, crop_pad=4, mean=(0.5,) * 3,
                         std=(0.25,) * 3, randaug_n=3,
                         exclude_color=exclude_color)
    g = torch.Generator().manual_seed(0)
    dc = P.draw_crop(48, spec, g, "cpu")
    dr = P.draw_randaug(48, spec, g, "cpu")
    views = []
    for dev in ("cpu", cuda_device):
        raw = torch.from_numpy(x).to(dev)
        move = lambda d: type(d)(*(t.to(dev) for t in d))
        views.append((P.weak_augment(raw, spec, move(dc)).cpu(),
                      P.strong_augment(raw, spec, move(dc), move(dr)).cpu()))
    assert torch.equal(views[0][0], views[1][0])
    differ = (views[0][1] != views[1][1]).any(-1).float().mean().item()
    assert differ <= 5e-3, differ


@pytest.mark.cuda
def test_a_cpu_generator_gives_the_card_the_cpu_runs_draws(cuda_device,
                                                           tmp_path):
    """``Trainer(..., rng_device='cpu')`` on the card (the golden runs'
    setting) starts from the CPU run's state, the net's and the rewarder's
    init bit-equal, and augments the first batch from the CPU run's draws
    (weak views bit-equal, strong views within the geometric ops' 0.5% of
    pixels, as above); its generator stays where the CPU run's is."""
    from semireward_tpu_torch.core.trainer import Trainer
    from semireward_tpu_torch.validation import golden_config

    runs = [Trainer(golden_config("srflexmatch", iters=4,
                                  save_dir=str(tmp_path)), device=dev,
                    rng_device="cpu") for dev in ("cpu", cuda_device)]
    states = [{k: v.cpu() for k, v in tr.state.state_dict().items()
               if k != "rng"} for tr in runs]
    assert states[0].keys() == states[1].keys()
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    batches = [tr.make_batch(next(tr._make_loader())) for tr in runs]
    assert torch.equal(batches[0]["x_ulb_w"], batches[1]["x_ulb_w"].cpu())
    differ = (batches[0]["x_ulb_s"] != batches[1]["x_ulb_s"].cpu()).any(
        -1).float().mean().item()
    assert differ <= 5e-3, differ
    assert torch.equal(runs[0].generator.get_state(),
                       runs[1].generator.get_state())


@pytest.mark.cuda
def test_flax_batchnorm_takes_the_nets_bf16_channels_last_input(cuda_device):
    """The nets feed the BatchNorm bf16 activations in channels-last
    strides (NHWC input turned to NCHW by a permute), which takes CUDA's
    channels-last kernels: the running statistics move as on the CPU
    (within 1e-5 of their magnitude) and the output within 1%."""
    from semireward_tpu_torch.models.batchnorm import BatchNorm

    g = torch.Generator().manual_seed(1)
    x = (torch.randn(64, 16, 16, 32, generator=g) * 3 + 1).to(torch.bfloat16)
    outs, stats = [], []
    for dev in (torch.device("cpu"), cuda_device):
        bn = BatchNorm(32, momentum=0.9).to(dev)
        with torch.no_grad():
            out = bn(x.to(dev).permute(0, 3, 1, 2), train=True)
        outs.append(out.float().cpu())
        stats.append([bn.running_mean.cpu(), bn.running_var.cpu()])
    _close(outs[1].numpy(), outs[0].numpy(), 1e-2)
    for a, b in zip(stats[1], stats[0]):
        _close(a.numpy(), b.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the JPEG-folder datasets' decode on the card (nvJPEG, data/_nvjpeg.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory):
    """A seeded ImageNet-layout folder: 4 classes, 60 train images of
    200-500 px and the three planted files."""
    from semireward_tpu_torch.data.datasets import write_synthetic_jpeg_folder

    root = str(tmp_path_factory.mktemp("jpeg"))
    write_synthetic_jpeg_folder(root, 4, 60, 8, seed=5)
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("size", [256, 128])
def test_nvjpeg_decode_matches_the_cpu_route(cuda_device, jpeg_folder, size):
    """The card route (nvJPEG, then the antialiased resize on the card)
    against PIL on the CPU: within the bound the JAX package holds its
    native decoder to (mean |diff| < 4, 99th percentile <= 16); the batch
    lies on the card; nvJPEG rejects exactly the CMYK and PNG files, which
    are decoded on the host and counted."""
    from semireward_tpu_torch.data.cv_extra import get_imagenet

    card, _ = get_imagenet(jpeg_folder, size, cuda_device)
    host, _ = get_imagenet(jpeg_folder, size, "cpu")
    idx = np.arange(len(card))
    got = card.gather(idx)
    assert got.is_cuda and got.shape == (len(idx), size, size, 3)
    diff = np.abs(got.cpu().numpy().astype(int) - host.gather(idx))
    assert diff.mean() < 4.0 and np.percentile(diff, 99) <= 16, (
        diff.mean(), np.percentile(diff, 99))
    redone = sorted(os.path.basename(p) for p in card.redone_on_host)
    assert redone == ["planted_cmyk.JPEG", "planted_png.JPEG"], redone
    assert card.decoded_on_card == len(idx) - 2


@pytest.mark.cuda
def test_nvjpeg_gives_a_grayscale_jpeg_three_equal_channels(cuda_device,
                                                            jpeg_folder):
    from PIL import Image
    from semireward_tpu_torch.data._nvjpeg import NvJpeg, take

    path = glob.glob(os.path.join(jpeg_folder, "imagenet/train/*",
                                  "planted_gray.JPEG"))[0]
    dec = NvJpeg(cuda_device)
    with open(path, "rb") as f:
        img = take(dec.decode(f.read()))
    torch.cuda.synchronize()
    assert img.shape == (300, 400, 3)
    assert torch.equal(img[..., 0], img[..., 1])
    assert torch.equal(img[..., 1], img[..., 2])
    want = np.asarray(Image.open(path).convert("RGB")).astype(int)
    assert np.abs(img.cpu().numpy().astype(int) - want).max() <= 2
    dec.close()


@pytest.mark.cuda
def test_trainer_reports_the_files_redone_on_the_host(cuda_device,
                                                      jpeg_folder, tmp_path):
    """A Trainer on the folder (the data on the card by default): its
    batches come from nvJPEG and ``jpeg_counts`` names the rejected
    files once they were gathered."""
    from semireward_tpu_torch.config import get_config
    from semireward_tpu_torch.core.trainer import Trainer

    cfg = get_config(dict(
        algorithm="fixmatch", net="wrn_28_2", dataset="imagenet",
        data_dir=jpeg_folder, num_classes=4, num_labels=8, img_size=56,
        batch_size=4, eval_batch_size=8, num_train_iter=2, num_eval_iter=2,
        num_log_iter=1, save_dir=str(tmp_path), use_pretrain=False,
        resume=False, net_kwargs={"depth": 10, "widen_factor": 1}))
    tr = Trainer(cfg)
    assert tr.aug_spec.src_size == 64
    tr.train()
    tr.bundle.train_ulb.gather(np.arange(len(tr.bundle.train_ulb)))
    decoded, redone = tr.jpeg_counts()
    assert decoded > 0
    assert sorted(os.path.basename(p) for p in redone) == [
        "planted_cmyk.JPEG", "planted_png.JPEG"]


@pytest.mark.cuda
def test_a_failed_nvjpeg_build_or_handle_raises(cuda_device, jpeg_folder,
                                                monkeypatch):
    """No quiet fallback: a decoder that does not link (a missing library)
    and a handle that nvJPEG refuses both raise from ``gather``."""
    from semireward_tpu_torch.data import _nvjpeg
    from semireward_tpu_torch.data.cv_extra import get_imagenet
    from semireward_tpu_torch.ops import _build

    card, _ = get_imagenet(jpeg_folder, 64, cuda_device)
    monkeypatch.setitem(_build.LINK_FLAGS, "jpeg_decode",
                        ["-lnvjpeg_not_a_library"])
    monkeypatch.delitem(_build._loaded, "jpeg_decode", raising=False)
    with pytest.raises(RuntimeError, match="nvcc failed for jpeg_decode"):
        card.gather(np.arange(4))
    monkeypatch.undo()

    class Refusing:
        _srt_typed = True

        @staticmethod
        def srt_jpeg_handle_create(handle):
            return 1  # NVJPEG_STATUS_NOT_INITIALIZED

    monkeypatch.setattr(_nvjpeg, "_lib", lambda: Refusing)
    card, _ = get_imagenet(jpeg_folder, 64, cuda_device)
    with pytest.raises(RuntimeError, match="nvjpegCreateSimple failed"):
        card.gather(np.arange(4))
    assert card.decoded_on_card == 0 and not card.redone_on_host


def _bert_base_pair(cuda_device, layers=2, name="bert_base_uncased"):
    """The same BERT-base-width net (``layers`` deep) twice on the card:
    through K2 + K3 and through the plain attention and MLP."""
    from semireward_tpu_torch.models import get_net_builder

    builder = get_net_builder(name)
    nets = [builder(num_classes=4, device=cuda_device, layers=layers,
                    generator=torch.Generator(device=cuda_device
                                              ).manual_seed(0),
                    use_fused_mlp=k, use_flash=k) for k in (True, False)]
    nets[1].load_state_dict(nets[0].state_dict())
    return nets


def _tokens(cuda_device, vocab, B=4, N=512):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    lens = torch.tensor([N, 400, 300, 77], device=cuda_device)[:B]
    mask = (torch.arange(N, device=cuda_device)[None] < lens[:, None]).int()
    ids = torch.randint(5, vocab, (B, N), device=cuda_device, generator=g)
    return {"input_ids": ids * mask, "attention_mask": mask}


class _Eval(torch.nn.Module):
    """A net at ``train=False`` (no dropout: the kernels' hash stream and
    the plain path's generator stream are not the same masks)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, train=True, **kw):
        return self.net(x, train=False, **kw)


@pytest.mark.cuda
def test_vat_embed_probe_gradient_through_k2_and_k3(cuda_device):
    """VAT's probe on BERT-base's embeddings (``vat_embed``: the input
    gradient through K2 and K3's backward, N 512 with the key bias) against
    the same probe through the plain attention and MLP, on the same
    weights: per-sample cosine >= 0.99 (bf16 compute on both paths), and
    ``r_adv`` at norm ``vat_eps`` each."""
    from semireward_tpu_torch.algorithms import vat

    fused, plain = (_Eval(n) for n in _bert_base_pair(cuda_device))
    x = _tokens(cuda_device, 30522)
    grads = []
    for net in (fused, plain):
        out = net(x, return_embed=True)
        base, ul_y = out["embed"].detach(), out["logits"].detach().float()
        d = vat.draw_probe(base, torch.Generator(device=cuda_device
                                                 ).manual_seed(2))
        F.reset_launches()
        A.reset_launches()
        grads.append(vat.power_iteration(net, base, ul_y, d, None, x))
        torch.cuda.synchronize()
        if net is fused:
            assert A.launches == {"flash_attention_fwd": 2,
                                  "flash_attention_bwd": 2}
            assert F.launches["fused_mlp_blocked_fwd"] == 2
            assert F.launches["fused_mlp_blocked_bwd"] == 2
    g, w = (t.flatten(1).double() for t in grads)
    cos = (g * w).sum(1) / (g.norm(dim=1) * w.norm(dim=1))
    assert float(cos.min()) >= 0.99, cos
    r_adv = 6.0 * vat.l2_normalize(grads[0])
    assert torch.allclose(r_adv.flatten(1).norm(dim=1),
                          torch.full((4,), 6.0, device=cuda_device),
                          rtol=1e-4)


@pytest.mark.cuda
def test_fast_reverb_on_the_card_equals_the_cpu(cuda_device):
    """The fast reverb (``audio_exact_reverb False``) and the exact one on
    the card against the CPU's, within 1e-5 of the largest magnitude, on
    4 s clips at 16 kHz; the strong-view chain with the fast reverb too."""
    from semireward_tpu_torch.data import audio

    x = torch.randn(8, 64000, generator=torch.Generator().manual_seed(0))
    for fn in (audio._sox_reverb_wet, audio._sox_reverb_wet_exact):
        _close(fn(x.to(cuda_device)).cpu().numpy(), fn(x).numpy(), 1e-5)
    draws = audio.draw_strong_wave(torch.Generator().manual_seed(1), 8)
    draws["choice"][:, 0] = 3                    # a reverb first each clip
    got = audio.apply_strong_wave(
        x.to(cuda_device), {k: v.to(cuda_device) for k, v in draws.items()},
        exact_reverb=False).cpu().numpy()
    _close(got, audio.apply_strong_wave(x, draws, exact_reverb=False).numpy(),
           1e-4)


@pytest.mark.cuda
def test_dnabert_steps_on_the_card_through_k2_and_k3(cuda_device):
    """``dnabert_2_117m`` (BERT-base over the 4101 k-mer ids) on the card:
    its eval logits through K2 + K3 within 2% of the plain path's on the
    same weights (bf16), and one train step (dropout, the key bias at N
    512) through the kernels, a forward and a backward of each a layer,
    finite."""
    fused, plain = _bert_base_pair(cuda_device, layers=12,
                                   name="dnabert_2_117m")
    assert fused.word_embeddings.weight.shape == (4101, 768)
    x = _tokens(cuda_device, 4101)
    with torch.no_grad():
        want = plain(x, train=False)["logits"].float().cpu().numpy()
        got = fused(x, train=False)["logits"].float().cpu().numpy()
    _close(got, want, 2e-2)
    F.reset_launches()
    A.reset_launches()
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    out = fused(x, train=True, generator=gen)
    loss = torch.nn.functional.cross_entropy(
        out["logits"].float(), torch.arange(4, device=cuda_device))
    loss.backward()
    torch.cuda.synchronize()
    assert math.isfinite(float(loss))
    assert A.launches == {"flash_attention_fwd": 12,
                          "flash_attention_bwd": 12}
    assert F.launches["fused_mlp_blocked_fwd"] == 12
    assert F.launches["fused_mlp_blocked_bwd"] == 12
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in fused.parameters())


# ---------------------------------------------------------------------------
# K4: a shard's kernel call against the slice of one whole call
# ---------------------------------------------------------------------------

def _shard_mesh(nb, nm, rank):
    """Mesh coordinate ``rank`` of an ``nb`` x ``nm`` data x model layout
    (data alone where ``nm`` is 1) with no process groups: the K4
    wrappers' collectives are identities, so a wrapper on the rank's slice
    gives the rank's part."""
    from semireward_tpu_torch.parallel.mesh import Mesh
    if nm == 1:
        return Mesh((nb,), ("data",), rank=rank, groups=False)
    return Mesh((nb, nm), ("data", "model"), rank=rank, groups=False)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,nm", [(4, 1), (2, 2)])
def test_sharded_flash_gives_the_slices_of_one_call(cuda_device, nb, nm):
    """K2 at the BERT-base train shape (B 12, N 512, H 12, key bias,
    dropout 0.1) over ``nb`` batch x ``nm`` head shards: on each shard
    ``flash_attention_sharded`` (its mesh coordinate set) gives the whole
    ``flash_attention`` call's out and dq / dk / dv of its rows and heads
    bit for bit, and the kernel, its seed carrying the shard's global
    batch*head start (``seed_arg``), the whole call's lse and keep bits
    (one block a batch*head, no reduction across them)."""
    dev = cuda_device
    B, N, H, rate = 12, 512, 12, 0.1
    q, k, v, do, bias4 = _attn_inputs(dev, B, N, H, 64, pad=200)
    kb = A._key_bias_of(bias4, B, H, N)
    seed = torch.tensor([20240601], dtype=torch.int32, device=dev)
    _, lse, bits = A.kernel_fwd(q, k, v, kb, seed, rate, keep_bits=True)
    qw, kw, vw = (t.clone().requires_grad_() for t in (q, k, v))
    out = A.flash_attention(qw, kw, vw, bias4, rate, seed)
    grads = torch.autograd.grad(out, (qw, kw, vw), do)
    r, hl = B // nb, H // nm
    per_bh = lambda t: t.view(B, H, *t.shape[1:])
    A.reset_launches()
    for i in range(nb):
        for j in range(nm):
            bs, hs = slice(i * r, (i + 1) * r), slice(j * hl, (j + 1) * hl)
            qs, ks, vs = (t[bs, :, hs].clone().requires_grad_()
                          for t in (q, k, v))
            o = A.flash_attention_sharded(qs, ks, vs, bias4[bs], rate, seed,
                                          mesh=_shard_mesh(nb, nm,
                                                           i * nm + j))
            g = torch.autograd.grad(o, (qs, ks, vs), do[bs, :, hs])
            s4 = A.seed_arg(seed, dev, hl, bh_offset=i * r * H + j * hl,
                            local_heads=hl, head_stride=H)
            _, l, b = A.kernel_fwd(qs.detach(), ks.detach(), vs.detach(),
                                   A._key_bias_of(bias4[bs], r, hl, N), s4,
                                   rate, keep_bits=True)
            torch.cuda.synchronize()
            assert torch.equal(o, out[bs, :, hs]), (i, j)
            assert torch.equal(l, per_bh(lse)[bs, hs].reshape(r * hl, N))
            assert torch.equal(b, per_bh(bits)[bs, hs].reshape(r * hl, N, -1))
            for a, w in zip(g, grads):
                assert torch.equal(a, w[bs, :, hs]), (i, j)
    form = ("flash_attention_sharded_heads" if nm > 1
            else "flash_attention_sharded")
    assert A.launches_k4[form] == nb * nm


@pytest.mark.cuda
def test_sharded_flash_past_2_32_gives_the_slices_of_one_call(cuda_device):
    """A global counter past ``2**32`` (B 32, H 16, N 4096: ``B * H *
    Np**2 = 2**33``): the K4 form runs the kernel, whose counter wraps as
    :func:`attention_keep_mask`'s does, so each of 2 x 2 batch x head
    shards gives the whole call's out bit for bit, and the whole call's
    keep bits of a batch*head past the wrap are the plain stream's."""
    dev = cuda_device
    B, N, H, d, rate = 32, 4096, 16, 64, 0.1
    assert B * H * A.padded_len(N) ** 2 > 2 ** 32
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, N, H, d, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    out, _, bits = A.kernel_fwd(q, k, v, None, seed, rate, keep_bits=True)
    last = B * H - 1   # its counters start at 2**33 - 2**24: wrapped
    want = A.pack_keep_bits(A.attention_keep_mask(
        seed, 1, N, A.padded_len(N), A.keep_threshold(rate), bh_offset=last,
        local_heads=1, head_stride=1))
    assert torch.equal(bits[last:], want)
    del bits
    r, hl = B // 2, H // 2
    for i in range(2):
        for j in range(2):
            bs, hs = slice(i * r, (i + 1) * r), slice(j * hl, (j + 1) * hl)
            with torch.no_grad():
                o = A.flash_attention_sharded(
                    *(t[bs, :, hs] for t in (q, k, v)), None, rate, seed,
                    mesh=_shard_mesh(2, 2, i * 2 + j))
            torch.cuda.synchronize()
            assert torch.equal(o, out[bs, :, hs]), (i, j)


@pytest.mark.cuda
def test_unsharded_flash_bits_are_the_plain_stream(cuda_device):
    """The unsharded call's keep bits, with its seed as one int32 or as
    ``seed_arg``'s four ``(seed, 0, H, H)``, are the plain stream's
    (``pack_keep_bits(attention_keep_mask)``), as before the counter took
    the shard's offsets; so are those of the public function's
    forward."""
    dev = cuda_device
    B, N, H = 2, 200, 3
    q, k, v, _, bias4 = _attn_inputs(dev, B, N, H, 64, pad=37)
    kb = A._key_bias_of(bias4, B, H, N)
    seed = torch.tensor([424242], dtype=torch.int32, device=dev)
    want = A.pack_keep_bits(A.attention_keep_mask(
        seed, B * H, N, A.padded_len(N), A.keep_threshold(0.1)))
    for s in (seed, A.seed_arg(seed, dev, H)):
        _, _, bits = A.kernel_fwd(q, k, v, kb, s, 0.1, keep_bits=True)
        torch.cuda.synchronize()
        assert torch.equal(bits, want)
    out = A.flash_attention(q, k, v, bias4, 0.1, seed)
    p_out, _ = A.plain_fwd(q, k, v, kb, seed, 0.1)
    _close(out.float().cpu().numpy(), p_out.float().cpu().numpy(), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,h,split", [(6168, 384, 1536, "rows"),
                                         (6168, 384, 1536, "hidden"),
                                         (4776, 768, 3072, "rows"),
                                         (4776, 768, 3072, "hidden")])
def test_mlp_shards_sum_to_the_whole_call(cuda_device, m, c, h, split):
    """K4's MLP forms through autograd, each shard its mesh coordinate
    (no groups): ``fused_mlp_sharded`` on 4 row shards (the outputs and dx
    of each shard's rows, dW and db summed over the shards as the step's
    sync sums them) and ``fused_mlp_tp_sharded`` on 4 hidden slices (with
    a zero b2 the outputs are the partials: they and dx summed, as the
    form sums them over ``model``, plus b2 once; dW1, db1, dW2 the slices;
    db2 every slice's column sum; one slice with b2 against the plain
    partial + b2) against one
    whole ``fused_mlp`` call: 1e-2 of the largest magnitude for the bf16
    tensors, 1e-3 for the f32 bias sums (sums in another order)."""
    dev, n = cuda_device, 4
    x, w1, b1, w2, b2, gy = _mlp_inputs(dev, m, c, h)
    leaves = lambda ts: [t.clone().requires_grad_() for t in ts]
    ins = leaves((x, w1, b1, w2, b2))
    out = F.fused_mlp(*ins)
    want = (out,) + torch.autograd.grad(out, ins, gy)
    F.reset_launches()
    outs, parts = [], []
    for i in range(n):
        if split == "rows":
            s = slice(i * (m // n), (i + 1) * (m // n))
            ins, g = leaves((x[s], w1, b1, w2, b2)), gy[s]
            outs.append(F.fused_mlp_sharded(*ins, mesh=_shard_mesh(n, 1, i)))
        else:
            # a zero b2: each output is the partial the form sums over
            # ``model`` (its b2 goes on after the sum: checked below)
            s = slice(i * (h // n), (i + 1) * (h // n))
            ins = leaves((x, w1[s], b1[s], w2[:, s], torch.zeros_like(b2)))
            g = gy
            outs.append(F.fused_mlp_tp_sharded(
                *ins, mesh=_shard_mesh(1, n, i), hidden=h))
        parts.append(torch.autograd.grad(outs[-1], ins, g))
    torch.cuda.synchronize()
    np_ = lambda t: t.detach().float().cpu().numpy()
    if split == "rows":
        got = [torch.cat(outs), torch.cat([p[0] for p in parts])] + [
            sum(p[i].float() for p in parts) for i in (1, 2, 3, 4)]
        assert F.launches_k4["fused_mlp_sharded"] == n
    else:
        got = [sum(o.float() for o in outs) + b2,
               sum(p[0].float() for p in parts),
               torch.cat([p[1] for p in parts]),
               torch.cat([p[2] for p in parts]),
               torch.cat([p[3] for p in parts], 1), parts[0][4]]
        assert F.launches_k4["fused_mlp_tp_sharded"] == n
        # b2 added once after the partial: a slice with the real b2
        # against the plain version of partial + b2
        s = slice(0, h // n)
        with torch.no_grad():
            y = F.fused_mlp_tp_sharded(x, w1[s], b1[s], w2[:, s], b2,
                                       mesh=_shard_mesh(1, n, 0), hidden=h)
        _close(np_(y), np_(F.plain_fwd(x, w1[s], b1[s], w2[:, s].contiguous(),
                                       torch.zeros_like(b2)) + b2), 1e-2)
    for name, a, w in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), got,
                          want):
        _close(np_(a), np_(w), 1e-3 if name.startswith("db") else 1e-2)
