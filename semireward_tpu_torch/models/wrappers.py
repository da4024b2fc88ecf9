"""Algorithm-specific net wrappers (port of
``semireward_tpu/models/wrappers.py``): extra heads over any backbone.

RotNet (ReMixMatch's 4-way rotation head, over any net: the ``only_fc``
and ``only_feat`` calls pass through to it, images, token dicts or
waveforms alike), ProjectionNet (CoMatch) and
SimMatchNet (an l2-normalized projection head), CRMatchNet (rotation head
and the feature-level consistency head), AuxHeadNet (the ABC / TRAS
auxiliary head) and CoSSLNet (CoSSL's teacher head); the last two pass
other keywords (``use_rot``) on to the net they wrap, which may itself be
a wrapper (ABC over ReMixMatch: ``backbone.backbone.<name>``). Each keeps the net under the
attribute ``backbone``, so its parameters are named ``backbone.<name>`` as
the flax tree's are ``{'backbone': ...}``, and ``convert.load_flax_params``
maps one onto the other. Each head is a float32 ``nn.Linear`` over the
net's float32 features (flax's ``_dense``: ``param_dtype`` and ``dtype``
float32), initialized like every port Linear (torch-default kernel, zero
bias) from the generator given.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from semireward_tpu_torch.models.initializers import init_module_


def l2norm(x, power: int = 2):
    """``x / (sum_j x_j^power)^(1/power)`` over dim 1 (no epsilon, as in
    the JAX package)."""
    return x / x.pow(power).sum(1, keepdim=True).pow(1.0 / power)


def _dense(in_features: int, out_features: int, like: nn.Module,
           generator: Optional[torch.Generator]) -> nn.Linear:
    dev = next(like.parameters()).device
    return init_module_(nn.Linear(in_features, out_features, device=dev),
                        generator)


class _Wrapper(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone

    @property
    def num_features(self) -> int:
        return self.backbone.num_features

    @property
    def input_grad_is_zero(self) -> bool:
        return getattr(self.backbone, "input_grad_is_zero", False)

    def _passthrough(self, x, train, only_fc, only_feat, generator):
        return self.backbone(x, train=train, only_fc=only_fc,
                             only_feat=only_feat, generator=generator)

    def _features(self, x, train, generator):
        feat = self.backbone(x, train=train, only_feat=True,
                             generator=generator)
        return feat, self.backbone(feat, only_fc=True)


class RotNet(_Wrapper):
    """ReMixMatch: an extra 4-way rotation classifier, applied with
    ``use_rot``."""

    def __init__(self, backbone: nn.Module,
                 generator: Optional[torch.Generator] = None):
        super().__init__(backbone)
        self.rot_classifier = _dense(backbone.num_features, 4, backbone,
                                     generator)

    def forward(self, x, train: bool = True, use_rot: bool = False,
                only_fc: bool = False, only_feat: bool = False,
                generator=None):
        if only_fc or only_feat:
            return self._passthrough(x, train, only_fc, only_feat, generator)
        feat, logits = self._features(x, train, generator)
        out = {"logits": logits, "feat": feat}
        if use_rot:
            out["logits_rot"] = self.rot_classifier(feat)
        return out


class ProjectionNet(_Wrapper):
    """CoMatch: ``feat`` becomes the l2-normalized projection
    ``Linear(nf, nf) -> ReLU -> Linear(nf, proj_size)``."""

    def __init__(self, backbone: nn.Module, proj_size: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__(backbone)
        nf = backbone.num_features
        self.mlp_proj_fc1 = _dense(nf, nf, backbone, generator)
        self.mlp_proj_fc2 = _dense(nf, proj_size, backbone, generator)

    def forward(self, x, train: bool = True, only_fc: bool = False,
                only_feat: bool = False, generator=None):
        if only_fc or only_feat:
            return self._passthrough(x, train, only_fc, only_feat, generator)
        feat, logits = self._features(x, train, generator)
        h = self.mlp_proj_fc2(F.relu(self.mlp_proj_fc1(feat)))
        return {"logits": logits, "feat": l2norm(h)}


class SimMatchNet(ProjectionNet):
    """SimMatch: the same projection head as CoMatch's."""


class CRMatchNet(_Wrapper):
    """CRMatch: ``logits_ds`` (a linear over the pooled features, the
    feature-level consistency head) on every call, and the rotation head
    with ``use_rot``."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(backbone)
        nf = backbone.num_features
        self.ds_classifier = _dense(nf, num_classes, backbone, generator)
        self.rot_classifier = _dense(nf, 4, backbone, generator)

    def forward(self, x, train: bool = True, use_rot: bool = False,
                only_fc: bool = False, only_feat: bool = False,
                generator=None):
        if only_fc or only_feat:
            return self._passthrough(x, train, only_fc, only_feat, generator)
        feat, logits = self._features(x, train, generator)
        out = {"logits": logits, "feat": feat,
               "logits_ds": self.ds_classifier(feat)}
        if use_rot:
            out["logits_rot"] = self.rot_classifier(feat)
        return out


class AuxHeadNet(_Wrapper):
    """ABC and TRAS: an auxiliary linear head over the features,
    ``logits_aux`` on every full call; ``aux(feat)`` applies it alone."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(backbone)
        self.aux_classifier = _dense(backbone.num_features, num_classes,
                                     backbone, generator)

    def forward(self, x, train: bool = True, only_fc: bool = False,
                only_feat: bool = False, generator=None, **kw):
        if only_fc or only_feat:
            return self._passthrough(x, train, only_fc, only_feat, generator)
        out = self.backbone(x, train=train, generator=generator, **kw)
        return {**out, "logits_aux": self.aux_classifier(out["feat"])}

    def aux(self, feat):
        return self.aux_classifier(feat)


class CoSSLNet(_Wrapper):
    """CoSSL: the tail-feature-enhanced teacher head, ``logits_tfe`` on
    every full call; ``teacher(feat)`` applies it alone."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(backbone)
        self.teacher_classifier = _dense(backbone.num_features, num_classes,
                                         backbone, generator)

    def forward(self, x, train: bool = True, only_fc: bool = False,
                only_feat: bool = False, generator=None, **kw):
        if only_fc or only_feat:
            return self._passthrough(x, train, only_fc, only_feat, generator)
        out = self.backbone(x, train=train, generator=generator, **kw)
        return {**out, "logits_tfe": self.teacher_classifier(out["feat"])}

    def teacher(self, feat):
        return self.teacher_classifier(feat)
