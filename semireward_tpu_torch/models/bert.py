"""BERT-base classifier (port of ``semireward_tpu/models/bert.py``).

Post-LN encoder (12 layers, 768 hidden, 12 heads, GELU, LayerNorm eps 1e-12)
+ dropout 0.1 + mean pool over all positions (padding included, as the
reference's ``torch.mean(drop_hidden, 1)``) + a two-layer GELU head. ``x``
is a dict with ``input_ids`` and ``attention_mask`` ``[B, L]``; the mask
becomes an additive key bias of -1e9.

Same parameters and dtype policy as the flax model: parameters in float32;
embeddings, LayerNorms, features and head in float32; projections and MLP
in ``dtype`` (bfloat16 by default), the residual stream in ``dtype``.
Attention:

- ``use_flash``: :func:`ops.attention.flash_attention` with the key bias,
  and in training the in-kernel hash dropout (p = 0.1) from a fresh int32
  seed per layer per forward, drawn on the device from the step's generator
  (the flax model draws it from ``make_rng('dropout')``).
- otherwise scores in f32 products of the bf16 values, softmax in f32,
  dropout on the probabilities from the generator in training, probs cast
  to ``dtype`` before ``PV``.

Module names follow torch idiom (``layer.3`` for flax ``layer3``);
``semireward_tpu_torch.convert`` maps one onto the other.
``load_hf_bert_weights`` grafts a HuggingFace ``BertModel`` state dict.
Gradient checkpointing of the attention (``remat_attn``) is not ported yet
(ROADMAP).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from semireward_tpu_torch import rng
from semireward_tpu_torch.models.vit import (_dropout, _layer_norm,
                                             mlp_forward, out_proj, qkv_heads)
from semireward_tpu_torch.ops.attention import flash_fn

ATTN_DROP = 0.1
HIDDEN_DROP = 0.1


class BertSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype=torch.bfloat16,
                 use_flash: bool = False, mesh=None):
        super().__init__()
        self.heads, self.dtype, self.use_flash = heads, dtype, use_flash
        self.mesh = mesh
        for name in ("query", "key", "value", "output"):
            self.add_module(name, nn.Linear(hidden, hidden))

    def forward(self, x, attn_bias, train: bool, generator=None):
        B, L, C = x.shape
        hd = C // self.heads
        q, k, v, local = qkv_heads(x, (self.query, self.key, self.value), C,
                                   self.heads, self.dtype, self.mesh)
        Hl = q.shape[2]
        if self.use_flash:
            attend = flash_fn(self.mesh)
            if train:
                seed = rng.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                   device=x.device, dtype=torch.int32)
                out = attend(q, k, v, bias=attn_bias, dropout_rate=ATTN_DROP,
                             dropout_seed=seed)
            else:
                out = attend(q, k, v, bias=attn_bias)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))    # [B, H, L, hd]
            a = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
            a = F.softmax(a + attn_bias, dim=-1)
            a = _dropout(a, ATTN_DROP, train, generator,
                         cols=1 if local else None)
            out = torch.matmul(a.to(self.dtype), v).transpose(1, 2)
        out = out.reshape(B, L, Hl * hd).to(self.dtype)
        return out_proj(out, self.output, C, self.dtype, self.mesh, local)


class BertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int,
                 dtype=torch.bfloat16, use_fused: bool = False,
                 use_flash: bool = False, mesh=None):
        super().__init__()
        self.dtype, self.use_fused = dtype, use_fused
        self.inter, self.mesh = intermediate, mesh
        self.attention = BertSelfAttention(hidden, heads, dtype, use_flash,
                                           mesh)
        self.attention_ln = nn.LayerNorm(hidden, eps=1e-12)
        self.intermediate = nn.Linear(hidden, intermediate)
        self.output = nn.Linear(intermediate, hidden)
        self.output_ln = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, x, attn_bias, train: bool, generator=None):
        h = self.attention(x, attn_bias, train, generator)
        h = _dropout(h, HIDDEN_DROP, train, generator)
        x = _layer_norm(x + h, self.attention_ln).to(self.dtype)
        # dropout sits after fc2, so the fused kernel applies in training
        m = mlp_forward(x, self.intermediate, self.output, self.inter,
                        self.dtype, self.use_fused, self.mesh, train, 0.0,
                        generator)
        m = _dropout(m, HIDDEN_DROP, train, generator)
        return _layer_norm(x + m, self.output_ln).to(self.dtype)


class ClassificationBert(nn.Module):
    """``forward(x, train, only_fc, only_feat, return_embed, inputs_embeds,
    generator)`` returns ``{'logits', 'feat'}`` (+ ``'embed'``, the
    embedding-LayerNorm output, with ``return_embed``)."""

    def __init__(self, num_classes: int, vocab_size: int = 30522,
                 hidden: int = 768, layers: int = 12, heads: int = 12,
                 intermediate: int = 3072, max_position: int = 512,
                 type_vocab: int = 2, dtype=torch.bfloat16,
                 use_fused_mlp: bool = False, use_flash: bool = False,
                 fused_mesh=None):
        super().__init__()
        self.hidden, self.dtype = hidden, dtype
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Parameter(torch.empty(max_position,
                                                            hidden))
        self.token_type_embeddings = nn.Parameter(torch.empty(type_vocab,
                                                              hidden))
        self.embeddings_ln = nn.LayerNorm(hidden, eps=1e-12)
        self.layer = nn.ModuleList(
            BertLayer(hidden, heads, intermediate, dtype, use_fused_mlp,
                      use_flash, fused_mesh) for _ in range(layers))
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
                only_feat: bool = False, return_embed: bool = False,
                inputs_embeds: Optional[torch.Tensor] = None, generator=None):
        if only_fc:
            return self.head(x)
        ids = x["input_ids"]
        B, L = ids.shape
        mask = x.get("attention_mask")
        if mask is None:
            mask = torch.ones_like(ids)
        if inputs_embeds is None:
            inputs_embeds = x.get("inputs_embeds")
        # HF semantics: inputs_embeds replaces the WORD embeddings only
        base = (self.word_embeddings(ids.long()) if inputs_embeds is None
                else inputs_embeds.float())
        emb = base + self.position_embeddings[None, :L] \
            + self.token_type_embeddings[0][None, None]
        emb = _layer_norm(emb, self.embeddings_ln)
        h = _dropout(emb, HIDDEN_DROP, train, generator).to(self.dtype)
        attn_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(
            device=h.device, dtype=torch.float32)
        for blk in self.layer:
            h = blk(h, attn_bias, train, generator)
        drop = _dropout(h.float(), HIDDEN_DROP, train, generator)
        feat = drop.mean(1)
        if only_feat:
            return feat
        out = {"logits": self.head(feat), "feat": feat}
        if return_embed:
            out["embed"] = emb
        return out


def layer_id(names: List[str], num_layers: int) -> int:
    """Layer-decay group: embeddings = 0, encoder layer i = i + 1, the head
    = last (names are the dot-split parameter name)."""
    head = names[0] if names else ""
    if "embedding" in head or head == "embeddings_ln":
        return 0
    if head == "layer" and len(names) > 1 and names[1].isdigit():
        return int(names[1]) + 1
    return num_layers


_BERT_FIELDS = ("hidden", "layers", "heads", "intermediate", "max_position",
                "use_fused_mlp", "use_flash", "fused_mesh")


@torch.no_grad()
def init_bert_(model: nn.Module, generator=None) -> nn.Module:
    """The flax init: N(0, 0.02) kernels and embeddings, zero biases,
    LayerNorm scale 1."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            rng.init_(m.weight, torch.Tensor.normal_, 0.0, 0.02,
                      generator=generator)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for p in (model.position_embeddings, model.token_type_embeddings):
        rng.init_(p, torch.Tensor.normal_, 0.0, 0.02, generator=generator)
    return model


def _builder(name: str, vocab_size: int):
    def build(num_classes: int, dtype=torch.bfloat16, device=None,
              generator: Optional[torch.Generator] = None,
              **kw) -> ClassificationBert:
        fields = {k: v for k, v in kw.items() if k in _BERT_FIELDS}
        with torch.device("meta"):
            model = ClassificationBert(num_classes, vocab_size=vocab_size,
                                       dtype=dtype, **fields)
        return init_bert_(model.to_empty(device=device or "cpu"), generator)

    build.__name__ = name
    build.layer_id_fn = layer_id
    build.num_layers = 13
    return build


bert_base_uncased = _builder("bert_base_uncased", 30522)
bert_base_cased = _builder("bert_base_cased", 28996)


def load_hf_bert_weights(params: Mapping[str, torch.Tensor],
                         state_dict: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """Every parameter of the net, those of a HuggingFace ``BertModel``
    state dict (numpy-convertible values) grafted in; the head keeps its
    own. HF's names and layouts are the port's."""
    import numpy as np

    from semireward_tpu_torch.models.utils import Graft

    g = Graft(params)
    sd = {k.replace("bert.", "", 1): np.asarray(v)
          for k, v in state_dict.items()}
    g.put("word_embeddings.weight", sd["embeddings.word_embeddings.weight"])
    g.put("position_embeddings", sd["embeddings.position_embeddings.weight"])
    g.put("token_type_embeddings",
          sd["embeddings.token_type_embeddings.weight"])
    g.put("embeddings_ln.weight", sd["embeddings.LayerNorm.weight"])
    g.put("embeddings_ln.bias", sd["embeddings.LayerNorm.bias"])
    for i in range(g.count(r"layer\.(\d+)\.")):
        src, dst = f"encoder.layer.{i}.", f"layer.{i}."
        for ours, hf in (("attention.query", "attention.self.query"),
                         ("attention.key", "attention.self.key"),
                         ("attention.value", "attention.self.value"),
                         ("attention.output", "attention.output.dense"),
                         ("attention_ln", "attention.output.LayerNorm"),
                         ("intermediate", "intermediate.dense"),
                         ("output", "output.dense"),
                         ("output_ln", "output.LayerNorm")):
            g.put(dst + ours + ".weight", sd[src + hf + ".weight"])
            g.put(dst + ours + ".bias", sd[src + hf + ".bias"])
    return g.result()
