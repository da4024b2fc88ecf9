"""HuBERT-base audio classifier (port of ``semireward_tpu/models/hubert.py``;
``models/wav2vec2.py`` builds wav2vec2-base on the same body).

The shared wav2vec2/HuBERT-base body + dropout + mean pool + a two-layer
GELU head:

- conv feature extractor: 7 temporal convs (512 channels; k/s = 10/5,
  3/2 x4, 2/2 x2), GroupNorm on the first, GELU; frozen: it runs under
  ``torch.no_grad`` (the flax model's ``stop_gradient``), so its parameters
  get zero gradients from the train step (``core/step.py``);
- feature projection: LayerNorm -> Linear 512 -> hidden -> dropout;
- convolutional relative positional embedding (k 128, 16 groups) + post-LN
  encoder: ``layers`` layers of ``hidden`` width, ``heads`` heads, an
  intermediate of 3072 (the flax layer's fixed default).

Same parameters and dtype policy as the flax model: parameters in float32;
convs, projections and the MLP in ``dtype`` (bfloat16 by default); GroupNorm
and LayerNorms in float32, the residual stream in ``dtype``; features and
head in float32. Attention:

- ``use_flash`` (in training, and in eval when L >= 128, the flax gate):
  :func:`ops.attention.flash_attention` without bias, with the in-kernel
  hash dropout (p = 0.1) in training from a fresh int32 seed per layer per
  forward drawn on the device from the step's generator;
- otherwise f32 scores of the bf16 values, softmax in f32, dropout on the
  probabilities from the generator in training, probs in ``dtype`` before
  ``PV``.

``use_fused_mlp`` runs the MLP through :func:`ops.fused_mlp.fused_mlp` (K3 on
the card at C = 768); the flax layer puts dropout after ff2, so the fused
MLP applies in training too. ``x`` is a float waveform batch ``[B, T]`` (or
a dict with ``input_values``).

Module names follow the flax tree (``feature_extractor.conv3``, ``fp_proj``,
``layer.3.ff1``), so ``semireward_tpu_torch.convert`` maps one onto the
other. ``load_hf_audio_weights`` grafts a HuggingFace ``HubertModel`` /
``Wav2Vec2Model`` state dict. Gradient checkpointing of the attention
(``remat_attn``) is not ported yet (ROADMAP).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from semireward_tpu_torch import rng
from semireward_tpu_torch.models.vit import (_dropout, _layer_norm, _linear,
                                             mlp_forward, out_proj, qkv_heads)
from semireward_tpu_torch.ops.attention import flash_fn

DROP = 0.1
INTERMEDIATE = 3072
_CONVS = [(512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
          (512, 2, 2), (512, 2, 2)]


class FeatureExtractor(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = 1
        for i, (ch, k, s) in enumerate(_CONVS):
            self.add_module(f"conv{i}", nn.Conv1d(cin, ch, k, stride=s,
                                                  bias=False))
            cin = ch
        self.gn0 = nn.GroupNorm(512, 512, eps=1e-5)

    @torch.no_grad()
    def forward(self, x):                         # x [B, T] -> [B, T', 512]
        h = x[:, None, :].to(self.dtype)
        for i, (_, _, s) in enumerate(_CONVS):
            h = F.conv1d(h, getattr(self, f"conv{i}").weight.to(self.dtype),
                         stride=s)
            if i == 0:
                h = F.group_norm(h.float(), 512, self.gn0.weight,
                                 self.gn0.bias, self.gn0.eps).to(self.dtype)
            h = F.gelu(h)
        return h.transpose(1, 2)


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int = 768, heads: int = 12,
                 intermediate: int = INTERMEDIATE, dtype=torch.bfloat16,
                 use_fused: bool = False, use_flash: bool = False,
                 mesh=None):
        super().__init__()
        self.hidden, self.heads, self.dtype = hidden, heads, dtype
        self.use_fused, self.use_flash = use_fused, use_flash
        self.inter, self.mesh = intermediate, mesh
        for name in ("q", "k", "v", "out"):
            self.add_module(name, nn.Linear(hidden, hidden))
        self.ln1 = nn.LayerNorm(hidden, eps=1e-5)
        self.ff1 = nn.Linear(hidden, intermediate)
        self.ff2 = nn.Linear(intermediate, hidden)
        self.ln2 = nn.LayerNorm(hidden, eps=1e-5)

    def attention(self, x, train: bool, generator=None):
        B, L, C = x.shape
        hd = C // self.heads
        q, k, v, local = qkv_heads(x, (self.q, self.k, self.v), C,
                                   self.heads, self.dtype, self.mesh)
        Hl = q.shape[2]
        if self.use_flash and (train or L >= 128):
            attend = flash_fn(self.mesh)
            if train:
                seed = rng.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                   device=x.device, dtype=torch.int32)
                o = attend(q, k, v, dropout_rate=DROP, dropout_seed=seed)
            else:
                o = attend(q, k, v)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, hd]
            a = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
            a = _dropout(F.softmax(a, dim=-1), DROP, train, generator,
                         cols=1 if local else None)
            o = torch.matmul(a.to(self.dtype), v).transpose(1, 2)
        return out_proj(o.reshape(B, L, Hl * hd).to(self.dtype), self.out, C,
                        self.dtype, self.mesh, local)

    def forward(self, x, train: bool, generator=None):
        o = _dropout(self.attention(x, train, generator), DROP, train,
                     generator)
        x = _layer_norm(x + o, self.ln1).to(self.dtype)
        m = mlp_forward(x, self.ff1, self.ff2, self.inter, self.dtype,
                        self.use_fused, self.mesh, train, 0.0, generator)
        m = _dropout(m, DROP, train, generator)
        return _layer_norm(x + m, self.ln2).to(self.dtype)


class ClassificationAudioTransformer(nn.Module):
    """``forward(x, train, only_fc, only_feat, generator)`` returns
    ``{'logits', 'feat'}``; ``only_fc`` maps pooled features to logits
    through the head alone (the flax model's ``head``)."""

    # the frozen extractor cuts every gradient with respect to the waveform:
    # exactly 0, as under the flax model's stop_gradient (VAT reads this)
    input_grad_is_zero = True

    def __init__(self, num_classes: int, hidden: int = 768, layers: int = 12,
                 heads: int = 12, dtype=torch.bfloat16,
                 use_fused_mlp: bool = False, use_flash: bool = False,
                 fused_mesh=None):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        self.feature_extractor = FeatureExtractor(dtype)
        self.fp_ln = nn.LayerNorm(512, eps=1e-5)
        self.fp_proj = nn.Linear(512, hidden)
        self.pos_conv = nn.Conv1d(hidden, hidden, 128, padding=64, groups=16)
        self.encoder_ln = nn.LayerNorm(hidden, eps=1e-5)
        self.layer = nn.ModuleList(
            EncoderLayer(hidden, heads, dtype=dtype, use_fused=use_fused_mlp,
                         use_flash=use_flash, mesh=fused_mesh)
            for _ in range(layers))
        self.classifier_fc1 = nn.Linear(hidden, hidden)
        self.classifier_fc2 = nn.Linear(hidden, num_classes)

    @property
    def num_features(self) -> int:
        return self.hidden

    def head(self, feat):
        h = F.gelu(F.linear(feat.float(), self.classifier_fc1.weight,
                            self.classifier_fc1.bias))
        return F.linear(h, self.classifier_fc2.weight, self.classifier_fc2.bias)

    def forward(self, x, train: bool = True, only_fc: bool = False,
                only_feat: bool = False, generator=None):
        if only_fc:
            return self.head(x)
        if isinstance(x, dict):
            x = x.get("input_values", x)
        feats = self.feature_extractor(x)                 # frozen
        h = _layer_norm(feats, self.fp_ln)
        h = _linear(h, self.fp_proj, self.dtype)
        h = _dropout(h, DROP, train, generator)
        L = h.shape[1]
        pos = F.conv1d(h.transpose(1, 2), self.pos_conv.weight.to(self.dtype),
                       self.pos_conv.bias.to(self.dtype), padding=64,
                       groups=16)[..., :L]
        h = h + F.gelu(pos).transpose(1, 2)
        h = _layer_norm(h, self.encoder_ln).to(self.dtype)
        h = _dropout(h, DROP, train, generator)
        for blk in self.layer:
            h = blk(h, train, generator)
        feat = _dropout(h.float(), DROP, train, generator).mean(1)
        if only_feat:
            return feat
        return {"logits": self.head(feat), "feat": feat}


def layer_id(names: List[str], num_layers: int) -> int:
    """Layer-decay group: the front end (feature extractor, projection,
    positional conv, encoder LayerNorm) = 0, encoder layer i = i + 1, the
    head = last (names are the dot-split parameter name)."""
    head = names[0] if names else ""
    if head in ("feature_extractor", "fp_ln", "fp_proj", "pos_conv",
                "encoder_ln"):
        return 0
    if head == "layer" and len(names) > 1 and names[1].isdigit():
        return int(names[1]) + 1
    return num_layers


@torch.no_grad()
def init_audio_(model: nn.Module, generator=None) -> nn.Module:
    """The flax init: N(0, 0.02) conv and dense kernels, zero biases,
    norm scale 1."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            rng.init_(m.weight, torch.Tensor.normal_, 0.0, 0.02,
                      generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


_FIELDS = ("hidden", "layers", "heads", "use_fused_mlp", "use_flash",
           "fused_mesh")


def _builder(name: str):
    def build(num_classes: int, dtype=torch.bfloat16, device=None,
              generator: Optional[torch.Generator] = None,
              **kw) -> ClassificationAudioTransformer:
        fields = {k: v for k, v in kw.items() if k in _FIELDS}
        if "num_layers" in kw:
            fields["layers"] = kw["num_layers"]
        with torch.device("meta"):
            model = ClassificationAudioTransformer(num_classes, dtype=dtype,
                                                   **fields)
        return init_audio_(model.to_empty(device=device or "cpu"), generator)

    build.__name__ = name
    build.layer_id_fn = layer_id
    build.num_layers = 13
    return build


hubert_base = _builder("hubert_base")


def load_hf_audio_weights(params: Mapping[str, torch.Tensor],
                          state_dict: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """Every parameter of the net, those of a HuggingFace ``HubertModel`` /
    ``Wav2Vec2Model`` state dict (numpy-convertible values) grafted in; the
    head keeps its own. The positional conv is weight-normed in HF: both
    storage formats (``weight_g`` / ``weight_v`` and torch 2's
    ``parametrizations.weight.original0/1``) are recomposed, ``w = v * g /
    ||v||`` over each kernel tap, in float64 as the JAX package does."""
    import numpy as np

    from semireward_tpu_torch.models.utils import Graft

    g = Graft(params)
    sd = {}
    for k, v in state_dict.items():
        stripped = True
        while stripped:  # wrapper checkpoints nest, e.g. 'model.hubert.'
            stripped = False
            for pre in ("hubert.", "wav2vec2.", "model."):
                if k.startswith(pre):
                    k = k[len(pre):]
                    stripped = True
        sd[k] = np.asarray(v)
    for i in range(len(_CONVS)):
        g.put(f"feature_extractor.conv{i}.weight",
              sd[f"feature_extractor.conv_layers.{i}.conv.weight"])
    g.put("feature_extractor.gn0.weight",
          sd["feature_extractor.conv_layers.0.layer_norm.weight"])
    g.put("feature_extractor.gn0.bias",
          sd["feature_extractor.conv_layers.0.layer_norm.bias"])
    for ours, hf in (("fp_ln", "feature_projection.layer_norm"),
                     ("fp_proj", "feature_projection.projection")):
        g.put(ours + ".weight", sd[hf + ".weight"])
        g.put(ours + ".bias", sd[hf + ".bias"])
    pc = "encoder.pos_conv_embed.conv."
    if pc + "weight_g" in sd:
        wg, wv = sd[pc + "weight_g"], sd[pc + "weight_v"]
    else:
        wg = sd[pc + "parametrizations.weight.original0"]
        wv = sd[pc + "parametrizations.weight.original1"]
    norm = np.sqrt((wv.astype(np.float64) ** 2).sum(axis=(0, 1),
                                                    keepdims=True))
    g.put("pos_conv.weight", (wv * (wg / norm)).astype(np.float32))
    g.put("pos_conv.bias", sd[pc + "bias"])
    g.put("encoder_ln.weight", sd["encoder.layer_norm.weight"])
    g.put("encoder_ln.bias", sd["encoder.layer_norm.bias"])
    for i in range(g.count(r"layer\.(\d+)\.")):
        src, dst = f"encoder.layers.{i}.", f"layer.{i}."
        for ours, hf in (("q", "attention.q_proj"), ("k", "attention.k_proj"),
                         ("v", "attention.v_proj"),
                         ("out", "attention.out_proj"),
                         ("ff1", "feed_forward.intermediate_dense"),
                         ("ff2", "feed_forward.output_dense"),
                         ("ln1", "layer_norm"), ("ln2", "final_layer_norm")):
            g.put(dst + ours + ".weight", sd[src + hf + ".weight"])
            g.put(dst + ours + ".bias", sd[src + hf + ".bias"])
    return g.result()
