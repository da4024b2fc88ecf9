"""WideResNet-28-{2,8} and WRN-Var-37-2 (port of
``semireward_tpu/models/wrn.py``).

Same parameters, statistics and dtype policy as the flax nets:

- BatchNorm with flax's semantics (``models/batchnorm.py``), momentum 0.999
  (torch's 0.001); the block BNs have eps 1e-5, the final one 1e-3;
- LeakyReLU 0.1;
- convs kaiming-normal on fan_out, the classifier xavier-normal, the first
  conv with a bias, every other conv without;
- convs and BNs compute in ``dtype`` (bf16 by default) with float32
  parameters and statistics; ``feat`` is the global average pool in
  float32, the classifier float32.

The input is NHWC like the flax net's and is turned to NCHW once for the
convs. A block whose widths differ and that does not activate before the
residual feeds its RAW input to conv1 (the reference's branch structure):
its bn1 output is unused, but bn1's running statistics still update.
Module names follow the flax tree (``block1.layer.0.bn1`` for flax's
``block1/layer0/bn1``); ``semireward_tpu_torch.convert`` maps one onto the
other.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from semireward_tpu_torch import rng
from semireward_tpu_torch.models.batchnorm import BatchNorm

_BN_MOM = 0.999  # flax momentum; the reference's torch momentum 0.001


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _conv(x, conv: nn.Conv2d, dtype):
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, stride: int,
                 activate_before_residual: bool = False,
                 dtype=torch.bfloat16, bn_momentum: float = _BN_MOM):
        super().__init__()
        self.equal_in_out = in_planes == out_planes
        self.activate_before_residual = activate_before_residual
        self.dtype = dtype
        self.bn1 = BatchNorm(in_planes, bn_momentum, 1e-5)
        self.conv1 = nn.Conv2d(in_planes, out_planes, 3, stride, 1,
                               bias=False)
        self.bn2 = BatchNorm(out_planes, bn_momentum, 1e-5)
        self.conv2 = nn.Conv2d(out_planes, out_planes, 3, 1, 1, bias=False)
        if not self.equal_in_out:
            self.convShortcut = nn.Conv2d(in_planes, out_planes, 1, stride,
                                          0, bias=False)

    def forward(self, x, train: bool):
        bn1_out = _leaky(self.bn1(x, train))
        if self.equal_in_out:
            conv1_in, residual = bn1_out, x
        elif self.activate_before_residual:
            conv1_in = residual = bn1_out
        else:  # the dead-bn1 branch: only bn1's statistics see x
            conv1_in = residual = x
        out = _leaky(self.bn2(_conv(conv1_in, self.conv1, self.dtype), train))
        out = _conv(out, self.conv2, self.dtype)
        shortcut = (residual if self.equal_in_out
                    else _conv(residual, self.convShortcut, self.dtype))
        return shortcut + out


class NetworkBlock(nn.Module):
    def __init__(self, nb_layers: int, in_planes: int, out_planes: int,
                 stride: int, activate_before_residual: bool = False,
                 dtype=torch.bfloat16, bn_momentum: float = _BN_MOM):
        super().__init__()
        self.layer = nn.ModuleList(
            BasicBlock(in_planes if i == 0 else out_planes, out_planes,
                       stride if i == 0 else 1,
                       activate_before_residual and i == 0, dtype,
                       bn_momentum)
            for i in range(nb_layers))

    def forward(self, x, train: bool):
        for blk in self.layer:
            x = blk(x, train)
        return x


class WideResNet(nn.Module):
    """``forward(x NHWC, train, only_fc, only_feat)`` returns
    ``{'logits', 'feat'}`` (or the features / logits alone)."""

    def __init__(self, num_classes: int, first_stride: int = 1,
                 depth: int = 28, widen_factor: int = 2,
                 extra_block: bool = False, dtype=torch.bfloat16,
                 bn_momentum: float = _BN_MOM):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"WRN depth {depth}: (depth - 4) must divide by 6")
        n = (depth - 4) // 6
        w = widen_factor
        ch = [16, 16 * w, 32 * w, 64 * w] + ([128 * w] if extra_block else [])
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, ch[0], 3, 1, 1, bias=True)
        strides = [first_stride, 2, 2, 2]
        for i in range(1, len(ch)):
            self.add_module(f"block{i}", NetworkBlock(
                n, ch[i - 1], ch[i], strides[i - 1],
                activate_before_residual=(i == 1), dtype=dtype,
                bn_momentum=bn_momentum))
        self.num_blocks = len(ch) - 1
        self.bn1 = BatchNorm(ch[-1], bn_momentum, 1e-3)
        self.classifier = nn.Linear(ch[-1], num_classes)
        self.num_features = ch[-1]

    def forward(self, x, train: bool = True, only_fc: bool = False,
                only_feat: bool = False, generator=None):
        if only_fc:
            return F.linear(x.float(), self.classifier.weight,
                            self.classifier.bias)
        out = _conv(x.permute(0, 3, 1, 2), self.conv1, self.dtype)
        for i in range(1, self.num_blocks + 1):
            out = getattr(self, f"block{i}")(out, train)
        out = _leaky(self.bn1(out, train))
        # the pool accumulates in float32 and rounds to ``dtype`` (jnp.mean),
        # then the features go on in float32
        feat = out.mean((2, 3), dtype=torch.float32).to(out.dtype).float()
        if only_feat:
            return feat
        return {"logits": F.linear(feat, self.classifier.weight,
                                   self.classifier.bias),
                "feat": feat}


@torch.no_grad()
def _trunc_normal_(t: torch.Tensor, std: float, generator=None):
    """jax.nn.initializers' truncated normal: N(0, std) cut at two standard
    deviations, std corrected for the cut (variance_scaling's
    'truncated_normal')."""
    scale = std / 0.87962566103423978
    return rng.init_(t, nn.init.trunc_normal_, 0.0, scale, -2 * scale,
                     2 * scale, generator=generator)


@torch.no_grad()
def init_wrn_(model: WideResNet, generator=None) -> WideResNet:
    """The flax net's initializers: convs variance_scaling(2, fan_out,
    truncated normal), the classifier xavier (fan_avg, truncated normal),
    zero biases, BN scale 1 and bias 0, running mean 0 and variance 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            _trunc_normal_(m.weight, math.sqrt(2.0 / fan_out), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            fan_avg = (m.in_features + m.out_features) / 2
            _trunc_normal_(m.weight, math.sqrt(1.0 / fan_avg), generator)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return model


def layer_id(names: List[str], num_layers: int) -> int:
    """Layer-decay group: conv1 = 0, block i = i, bn1 / classifier = last
    (names are the dot-split parameter name)."""
    if not names:
        return num_layers
    head = names[0]
    if head == "conv1":
        return 0
    if head.startswith("block"):
        return int(head[5:])
    return num_layers


def _builder(name, **arch):
    def build(num_classes: int, dtype=torch.bfloat16, device=None,
              generator: Optional[torch.Generator] = None,
              bn_momentum: float = _BN_MOM, **kw) -> WideResNet:
        merged = dict(arch)
        # depth / widen_factor overrides for small runs, as the flax
        # builders take them; wrn_var_37_2 keeps its fixed geometry
        if name != "wrn_var_37_2":
            merged.update({k: kw[k] for k in ("depth", "widen_factor")
                           if k in kw})
        with torch.device("meta"):
            model = WideResNet(num_classes, dtype=dtype,
                               bn_momentum=bn_momentum, **merged)
        model = model.to_empty(device=device or "cpu")
        return init_wrn_(model, generator)

    build.__name__ = name
    build.layer_id_fn = layer_id
    build.num_layers = 4
    return build


wrn_28_2 = _builder("wrn_28_2", first_stride=1, depth=28, widen_factor=2)
wrn_28_8 = _builder("wrn_28_8", first_stride=1, depth=28, widen_factor=8)
# reference wrn_var.py: first stride 2, depth 28 plus a fourth block
wrn_var_37_2 = _builder("wrn_var_37_2", first_stride=2, depth=28,
                        widen_factor=2, extra_block=True)
