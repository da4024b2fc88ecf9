"""Modality pipelines (port of ``semireward_tpu/data/modality.py``, numpy
only): how raw datasets become per-step view batches.

- CV: the loader ships raw uint8; weak/strong views are built on the device
  (``data/augment``).
- NLP: the loader tokenizes on the host into a static length bucket; weak =
  the 'ori' text, strong = a random back-translation (the reference's
  "augmentation" is a table lookup, so there is nothing to run on the
  device).
- Audio: the loader random-crops to the fixed bucket; the strong views
  leave as raw crops under ``<key>_base`` and are transformed on the device
  (``data/audio.apply_strong_wave``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from semireward_tpu_torch.data.loader import batched, infinite_indices


class GenericBundle:
    """Bundle facade for non-CV datasets (duck-types SSLDataBundle)."""

    def __init__(self, splits, num_classes):
        self.train_lb = splits["train_lb"]
        self.train_ulb = splits["train_ulb"]
        self.eval = splits["eval"]
        self.test = splits.get("test")
        self.num_classes = num_classes
        self.mean = (0.0, 0.0, 0.0)
        self.std = (1.0, 1.0, 1.0)

    @property
    def ulb_dest_len(self):
        return len(self.train_ulb)

    @property
    def lb_dest_len(self):
        return len(self.train_lb)


def modality_of(net_name: str) -> str:
    if net_name.startswith("bert") or net_name.startswith("dnabert") \
            or "hf_text" in net_name:
        return "nlp"
    if net_name.startswith(("hubert", "wave2vec", "wav2vec")):
        return "audio"
    return "cv"


class NLPSSLLoader:
    """Yields tokenized view batches (keys shaped like the reference's nlp
    collator output): every view of a step padded to one static length
    bucket where the collator has ``collate_views``
    (data/nlp.py:NLPCollator), else each view padded by the collator's own
    ``views`` (data/bio.py:BioCollator, always to ``max_length``). Views
    are drawn key by key in the order of ``batch_keys``, from the same seeds
    and RandomState streams as the JAX loader, so both give the same
    batches.

    Several ranks (``rank`` of ``world`` batch shards; the caller divides
    the batch sizes by ``world``): each draws its rank-strided share of one
    shared permutation, its view draws rank-salted, as the JAX loader. With
    length buckets every rank must pad to the same bucket, the one the
    global batch needs: the union of the ranks' step-t indices is positions
    ``[t * world * bs, (t + 1) * world * bs)`` of the unstrided stream, so
    each rank re-derives the global batch, bounds its longest text by a
    per-text cap (the longest of the original and its augmentations, any
    strong pick) and picks the bucket with no collective."""

    def __init__(self, splits, collator, batch_size, ulb_batch_size,
                 batch_keys, seed=0, rank=0, world=1):
        self.lb = splits["train_lb"]
        self.ulb = splits["train_ulb"]
        self.col = collator
        self.keys = batch_keys
        self._lb = batched(infinite_indices(len(self.lb), seed, rank, world),
                           batch_size)
        self._ulb = batched(infinite_indices(len(self.ulb), seed + 1, rank,
                                             world), ulb_batch_size)
        self._rs = np.random.RandomState(seed + 2 + 1000 * rank)
        self._global = None
        if world > 1 and len(getattr(collator, "buckets", ())) > 1:
            self._global = (
                batched(self._global_stream(len(self.lb), seed, world),
                        batch_size * world),
                batched(self._global_stream(len(self.ulb), seed + 1, world),
                        ulb_batch_size * world),
                self._text_maxlens(self.lb), self._text_maxlens(self.ulb))

    @staticmethod
    def _global_stream(n, seed, world):
        """The unstrided stream whose rank-strided shares the ranks
        draw."""
        g = np.random.RandomState(seed)
        stop = n - (n % world)
        while True:
            perm = g.permutation(n)
            for i in range(stop):
                yield perm[i]

    def _text_maxlens(self, ds) -> np.ndarray:
        tl = self.col.token_len
        if getattr(ds, "augs", None):
            return np.asarray([max(tl(t), max(tl(a) for a in augs))
                               for t, augs in zip(ds.texts, ds.augs)],
                              np.int32)
        return np.asarray([tl(t) for t in ds.texts], np.int32)

    def global_length(self):
        """The bucket of this step's global batch (None on one rank)."""
        if self._global is None:
            return None
        glb, gulb, lens_lb, lens_ulb = self._global
        cap = max(int(lens_lb[next(glb)].max()),
                  int(lens_ulb[next(gulb)].max()))
        return self.col.bucket_for(cap)

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        li = next(self._lb)
        ui = next(self._ulb)
        out = {"y_lb": self.lb.targets[li],
               "idx_lb": li.astype(np.int32),
               "idx_ulb": ui.astype(np.int32)}
        if hasattr(self.col, "collate_views"):
            out.update(self.col.collate_views(self.lb, self.ulb, li, ui,
                                              self.keys, self._rs,
                                              length=self.global_length()))
            return out
        for k in self.keys:
            if k in ("x_lb", "x_lb_s"):
                out[k] = self.col.views(self.lb, li, self._rs,
                                        strong=k == "x_lb_s")
            elif k in ("x_ulb_w", "x_ulb_w_2"):
                out[k] = self.col.views(self.ulb, ui, self._rs, strong=False)
            elif k.startswith("x_ulb_s"):
                out[k] = self.col.views(self.ulb, ui, self._rs, strong=True)
        return out


class AudioSSLLoader:
    """Yields fixed-bucket waveform batches; the strong views carry a fresh
    raw crop under ``x_ulb_s*_base`` and are transformed on the device. The
    same seeds and RandomState stream as the JAX loader, so both give the
    same batches; several ranks as :class:`NLPSSLLoader` (one fixed bucket,
    nothing to agree on)."""

    def __init__(self, splits, collator, batch_size, ulb_batch_size,
                 batch_keys, seed=0, rank=0, world=1):
        self.lb = splits["train_lb"]
        self.ulb = splits["train_ulb"]
        self.col = collator
        self.keys = batch_keys
        self._lb = batched(infinite_indices(len(self.lb), seed, rank, world),
                           batch_size)
        self._ulb = batched(infinite_indices(len(self.ulb), seed + 1, rank,
                                             world), ulb_batch_size)
        self._rs = np.random.RandomState(seed + 2 + 1000 * rank)

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        li = next(self._lb)
        ui = next(self._ulb)
        out = {"y_lb": self.lb.targets[li],
               "idx_lb": li.astype(np.int32),
               "idx_ulb": ui.astype(np.int32)}
        lb_waves = [self.lb.waves[i] for i in li]
        ulb_waves = [self.ulb.waves[i] for i in ui]
        for k in self.keys:
            if k == "x_lb":
                out[k] = self.col(lb_waves, self._rs)
            elif k in ("x_ulb_w", "x_ulb_w_2"):
                out[k] = self.col(ulb_waves, self._rs)
            elif k.startswith("x_ulb_s"):
                out[k + "_base"] = self.col(ulb_waves, self._rs)
        return out
