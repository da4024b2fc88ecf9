"""ResNet-50 (port of ``semireward_tpu/models/resnet.py``): the torchvision
bottleneck v1, layers (3, 4, 6, 3), with the ``{'logits', 'feat'}``
contract.

Same parameters, statistics and dtype policy as the flax net:

- BatchNorm with flax's semantics (``models/batchnorm.py``), momentum 0.9
  (torch's 0.1), eps 1e-5; the builder ignores a ``bn_momentum``, as the
  flax builder does;
- the stem: a 7x7 stride-2 conv padded 3, BatchNorm, ReLU, and a 3x3
  stride-2 max pool padded 1 (flax pads it with -inf, as torch does);
- each bottleneck: 1x1, 3x3 (the stage's stride), 1x1 convs without bias,
  each followed by BatchNorm, a ReLU after the first two and after the
  residual sum; the first block of a stage projects its input
  (``conv_ds`` + ``bn_ds``);
- convs kaiming-normal on fan_out (untruncated), the classifier
  ``fc`` flax's Dense default (truncated lecun normal), zero bias;
- convs and BatchNorms compute in ``dtype`` (bf16 by default) with
  float32 parameters and statistics; ``feat`` is the global average pool
  (float32 sum, rounded to ``dtype``) in float32, ``fc`` float32.

The input is NHWC like the flax net's and is turned to NCHW once. Module
names follow torch idiom (``layer1.0.conv1`` for flax's ``layer1_0/conv1``);
``semireward_tpu_torch.convert`` maps one onto the other.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from semireward_tpu_torch import rng
from semireward_tpu_torch.models.batchnorm import BatchNorm
from semireward_tpu_torch.models.wrn import _conv, _trunc_normal_

_BN_MOM = 0.9  # flax momentum; torch's 0.1
LAYERS = (3, 4, 6, 3)


class Bottleneck(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int,
                 downsample: bool, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, _BN_MOM, 1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes, _BN_MOM, 1e-5)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4, _BN_MOM, 1e-5)
        self.downsample = downsample
        if downsample:
            self.conv_ds = nn.Conv2d(in_planes, planes * 4, 1, stride,
                                     bias=False)
            self.bn_ds = BatchNorm(planes * 4, _BN_MOM, 1e-5)

    def forward(self, x, train: bool):
        dt = self.dtype
        out = F.relu(self.bn1(_conv(x, self.conv1, dt), train))
        out = F.relu(self.bn2(_conv(out, self.conv2, dt), train))
        out = self.bn3(_conv(out, self.conv3, dt), train)
        identity = (self.bn_ds(_conv(x, self.conv_ds, dt), train)
                    if self.downsample else x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """``forward(x NHWC, train, only_fc, only_feat)`` returns
    ``{'logits', 'feat'}`` (or the features / logits alone)."""

    num_features = 2048

    def __init__(self, num_classes: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64, _BN_MOM, 1e-5)
        in_planes, planes = 64, 64
        for li, n_blocks in enumerate(LAYERS):
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                blocks.append(Bottleneck(in_planes, planes, stride, bi == 0,
                                         dtype))
                in_planes = planes * 4
            self.add_module(f"layer{li + 1}", nn.ModuleList(blocks))
            planes *= 2
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x, train: bool = True, only_fc: bool = False,
                only_feat: bool = False, generator=None):
        if only_fc:
            return F.linear(x.float(), self.fc.weight, self.fc.bias)
        h = F.relu(self.bn1(_conv(x.permute(0, 3, 1, 2), self.conv1,
                                  self.dtype), train))
        h = F.max_pool2d(h, 3, 2, 1)
        for li in range(len(LAYERS)):
            for blk in getattr(self, f"layer{li + 1}"):
                h = blk(h, train)
        feat = h.mean((2, 3), dtype=torch.float32).to(h.dtype).float()
        if only_feat:
            return feat
        return {"logits": F.linear(feat, self.fc.weight, self.fc.bias),
                "feat": feat}


@torch.no_grad()
def init_resnet_(model: ResNet50, generator=None) -> ResNet50:
    """The flax net's initializers: convs variance_scaling(2, fan_out,
    normal), ``fc`` lecun normal (fan_in, truncated), zero bias, BN scale 1
    and bias 0, running mean 0 and variance 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            rng.init_(m.weight, torch.Tensor.normal_, 0.0,
                      math.sqrt(2.0 / fan_out), generator=generator)
        elif isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, math.sqrt(1.0 / m.in_features),
                           generator)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return model


def layer_id(names: List[str], num_layers: int) -> int:
    """Layer-decay group: the stem (conv1, bn1) = 0, ``layerN`` = N, fc =
    last (names are the dot-split parameter name)."""
    head = names[0] if names else ""
    if head in ("conv1", "bn1"):
        return 0
    if head.startswith("layer"):
        return int(head[5])
    return num_layers


def resnet50(num_classes: int, dtype=torch.bfloat16, device=None,
             generator: Optional[torch.Generator] = None, **kw) -> ResNet50:
    """The registry's builder; every other keyword (``img_size``,
    ``bn_momentum``, ``remat``, the kernel switches) is ignored, as the flax
    builder ignores it."""
    with torch.device("meta"):
        model = ResNet50(num_classes, dtype=dtype)
    model = model.to_empty(device=device or "cpu")
    return init_resnet_(model, generator)


resnet50.layer_id_fn = layer_id
resnet50.num_layers = 5
