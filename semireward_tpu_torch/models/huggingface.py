"""HF-auto style text classifiers (port of
``semireward_tpu/models/huggingface.py``) on the port's BERT encoder.

- ``dnabert_2_117m``: DNABERT-2-117M's geometry, BERT-base (12 layers, 768
  hidden, 12 heads) over the 4101-id k-mer vocabulary (``data/bio.py``:
  5 specials + 4^6).
- ``hf_text_classifier``: the generic builder, a BERT of the given vocabulary,
  width, depth and heads (the intermediate and positions at BERT-base's).

Both take ``use_fused_mlp`` and ``use_flash`` as the BERT builders do, so
that on a card their MLPs run K3 (at C 768) and their attention K2. The
flax builders drop both keywords (their encoders always run the plain
attention and MLP); the numbers are the same within the kernels'
tolerances, and the port's trainer turns the kernels on for these nets as
for ``bert_*`` (``core/trainer.py``). Layer decay groups as BERT's:
``layer_id_fn`` and 13 layers.
"""
from __future__ import annotations

import torch

from semireward_tpu_torch.models.bert import _builder, layer_id

# DNABERT-2-117M: BERT-base over the k-mer vocabulary; ``hidden``,
# ``layers``, ``heads``, ``intermediate`` and ``max_position`` may be
# overridden (small runs)
dnabert_2_117m = _builder("dnabert_2_117m", 4101)


def hf_text_classifier(num_classes: int, vocab_size: int = 30522,
                       hidden: int = 768, layers: int = 12, heads: int = 12,
                       dtype=torch.bfloat16, device=None, generator=None,
                       **kw):
    """A BERT classifier of ``vocab_size`` ids, ``hidden`` wide, ``layers``
    deep with ``heads`` heads (the reference's get_(auto)model helpers);
    other geometry keywords are ignored, as in the flax builder."""
    kernels = {k: kw[k] for k in ("use_fused_mlp", "use_flash") if k in kw}
    return _builder("hf_text_classifier", vocab_size)(
        num_classes, dtype=dtype, device=device, generator=generator,
        hidden=hidden, layers=layers, heads=heads, **kernels)


hf_text_classifier.layer_id_fn = layer_id
hf_text_classifier.num_layers = 13
