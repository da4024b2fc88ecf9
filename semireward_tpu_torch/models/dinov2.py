"""DINOv2 backbones (port of ``semireward_tpu/models/dinov2.py``): the
ViT-B/14 and ViT-L/14 geometries on the port's ``VisionTransformer``
(patch 14, LayerScale at 1e-5), each at ``(img_size // 14) * 14`` pixels
(224 px: 16 x 16 patches and the class token, N 257). The ViT switches
(``use_fused_mlp``, ``use_flash``, ``remat``...) pass through as the JAX
builder passes them; the geometry is the builder's own. Released weights
graft through ``models/utils.py:load_vit_checkpoint``, as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import torch

from semireward_tpu_torch.models.vit import _VIT_ARGS, build_vit, layer_id

# what the builders fix; every other ViT argument passes through
_FIXED = ("num_classes", "img_size", "patch_size", "embed_dim", "depth",
          "num_heads", "init_values", "dtype")


def _build(name, embed_dim, depth, num_heads):
    def build(num_classes: int, dtype=torch.bfloat16, img_size: int = 224,
              device=None, generator: Optional[torch.Generator] = None,
              **kw):
        size = (img_size // 14) * 14
        extra = {k: v for k, v in kw.items()
                 if k in _VIT_ARGS and k not in _FIXED}
        return build_vit(num_classes, dtype, device, generator,
                         img_size=size or 224, patch_size=14,
                         embed_dim=embed_dim, depth=depth,
                         num_heads=num_heads, init_values=1e-5, **extra)

    build.__name__ = name
    build.layer_id_fn = layer_id
    build.num_layers = depth + 1
    return build


dinov2_vitb14 = _build("dinov2_vitb14", 768, 12, 12)
dinov2_vitl14 = _build("dinov2_vitl14", 1024, 24, 16)
