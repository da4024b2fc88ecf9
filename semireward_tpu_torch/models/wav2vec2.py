"""wav2vec2-base classifier (port of ``semireward_tpu/models/wav2vec2.py``).

For classification the wav2vec2-base body is HuBERT-base's (same conv
feature extractor, feature projection, conv positional embedding and
12-layer post-LN encoder; the quantizer never runs in the reference's
classification path), so it is the same module.
"""
from __future__ import annotations

from semireward_tpu_torch.models.hubert import _builder

wave2vecv2_base = _builder("wave2vecv2_base")
