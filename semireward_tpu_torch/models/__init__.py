"""Model zoo of the port: the ViT (and DINOv2 on it), BERT (with DNABERT-2 and the generic
HF text classifier), HuBERT, wav2vec2, WideResNet and ResNet-50 builders, registered under the JAX package's names. ``model(x, train, only_fc, only_feat, generator)`` returns
``{'logits', 'feat'}`` like the flax models."""
from __future__ import annotations

from semireward_tpu_torch.models import bert as _bert
from semireward_tpu_torch.models import dinov2 as _dinov2
from semireward_tpu_torch.models import huggingface as _hf
from semireward_tpu_torch.models import hubert as _hubert
from semireward_tpu_torch.models import resnet as _resnet
from semireward_tpu_torch.models import wav2vec2 as _wav2vec2
from semireward_tpu_torch.models import vit as _vit
from semireward_tpu_torch.models import wrn as _wrn
from semireward_tpu_torch.registry import NETS

for _name in ("vit_tiny_patch2_32", "vit_small_patch2_32",
              "vit_small_patch16_224", "vit_base_patch16_96",
              "vit_base_patch16_224"):
    NETS.register(getattr(_vit, _name), name=_name)
for _name in ("dinov2_vitb14", "dinov2_vitl14"):
    NETS.register(getattr(_dinov2, _name), name=_name)
for _name in ("bert_base_uncased", "bert_base_cased"):
    NETS.register(getattr(_bert, _name), name=_name)
for _name in ("dnabert_2_117m", "hf_text_classifier"):
    NETS.register(getattr(_hf, _name), name=_name)
NETS.register(_hubert.hubert_base, name="hubert_base")
NETS.register(_wav2vec2.wave2vecv2_base, name="wave2vecv2_base")
for _name in ("wrn_28_2", "wrn_28_8", "wrn_var_37_2"):
    NETS.register(getattr(_wrn, _name), name=_name)
NETS.register(_resnet.resnet50, name="resnet50")


def get_net_builder(net_name: str):
    """Name -> builder. Nets the port does not have yet raise KeyError
    listing the ones it has."""
    return NETS.get(net_name)
