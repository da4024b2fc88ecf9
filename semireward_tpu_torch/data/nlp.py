"""NLP datasets and the tokenizing collator (copy of
``semireward_tpu/data/nlp.py``, numpy only, so both packages give the same
token batches for the same seed).

Rebuild of reference semilearn/datasets/nlp_datasets/{json_data.py,
datasetbase.py} and collactors/nlp_collactor.py:
- JSON splits ``{train,dev,test}.json`` where each unlabeled sample carries
  pre-computed back-translation augmentations ('ori', 'aug_0', 'aug_1'); the
  strong view picks one at random (datasetbase.py:48-60).
- the collator tokenizes on the fly and pads each step batch to the smallest
  static length bucket that fits it (default 64/128/256/max_length), the
  JAX package's stand-in for the reference's per-batch dynamic padding.

Tokenizer: a HuggingFace tokenizer loaded from a LOCAL vocab when available
(no network); otherwise a deterministic hash tokenizer keeps the pipeline
runnable for tests and synthetic runs.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class TextDataset:
    texts: List[str]              # 'ori'
    augs: Optional[List[List[str]]]  # [aug_0, aug_1] per sample (ulb only)
    targets: np.ndarray

    def __len__(self):
        return len(self.texts)


def load_json_dataset(data_dir: str, name: str):
    """reference nlp_datasets/json_data.py:96-165."""
    base = os.path.join(data_dir, name)
    out = {}
    for split in ("train", "dev", "test"):
        path = os.path.join(base, f"{split}.json")
        with open(path) as f:
            d = json.load(f)
        texts, augs, ys = [], [], []
        for k, v in d.items():
            if isinstance(v, dict):
                texts.append(v.get("ori", v.get("text", "")))
                augs.append([v.get("aug_0", texts[-1]),
                             v.get("aug_1", texts[-1])])
                ys.append(int(v.get("label", 0)))
        out[split] = TextDataset(texts, augs, np.asarray(ys, np.int64))
    return out


class HashTokenizer:
    """Deterministic fallback tokenizer (whitespace + stable hashing into
    the BERT vocab range). NOT wordpiece — only for environments without a
    local vocab file; real runs load the HF tokenizer below."""

    cls_id, sep_id, pad_id = 101, 102, 0

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def encode_ids(self, text: str, max_length: int) -> list:
        """Unpadded token ids (CLS ... SEP), truncated to max_length."""
        import hashlib

        ids = [self.cls_id]
        for tok in text.lower().split()[: max_length - 2]:
            h = int(hashlib.md5(tok.encode()).hexdigest(), 16)
            ids.append(1000 + h % (self.vocab_size - 1100))
        ids.append(self.sep_id)
        return ids[:max_length]

    def encode(self, text: str, max_length: int) -> np.ndarray:
        ids = self.encode_ids(text, max_length)
        out = np.full(max_length, self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out


def get_tokenizer(net_name: str, vocab_dir: Optional[str] = None):
    """reference collactors/nlp_collactor.py builds a HF AutoTokenizer; we
    load from a local path (offline) and fall back to HashTokenizer."""
    try:
        from transformers import AutoTokenizer

        path = vocab_dir or net_name.replace("_", "-")
        tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

        class _Wrap:
            def encode_ids(self, text, max_length):
                e = tok(text, max_length=max_length, truncation=True)
                return list(e["input_ids"])

            def encode(self, text, max_length):
                e = tok(text, max_length=max_length, padding="max_length",
                        truncation=True)
                return np.asarray(e["input_ids"], np.int32)

        return _Wrap()
    except Exception:
        return HashTokenizer()


def auto_buckets(max_length: int) -> tuple:
    """Default static length buckets: 64/128/256 capped by max_length, plus
    max_length itself. 4 buckets bound the worst-case padding overhead at
    2x while matching the reference's
    dynamic-padding FLOP economics (nlp_collactor.py:49-126) on short-text
    sets."""
    return tuple(b for b in (64, 128, 256) if b < max_length) + (max_length,)


class NLPCollator:
    """Emits the reference's x_lb/x_ulb_w/x_ulb_s dict shape with
    {input_ids, attention_mask} values (nlp_collactor.py:49-126), padded to
    the smallest static length bucket that fits the batch (the reference
    pads dynamically to the batch max). ``buckets=None`` keeps the single
    max_length bucket."""

    pad_id = 0

    def __init__(self, tokenizer, max_length: int = 512, buckets=None):
        self.tok = tokenizer
        self.max_length = max_length
        bs = sorted(set(list(buckets or [])) | {max_length})
        self.buckets = tuple(b for b in bs if b <= max_length)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (>= 2 so CLS+SEP always fit)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _encode_ids(self, text: str) -> list:
        if hasattr(self.tok, "encode_ids"):
            return self.tok.encode_ids(text, self.max_length)
        # tokenizer without an unpadded path: trim trailing pads
        arr = self.tok.encode(text, self.max_length)
        nz = np.nonzero(arr != self.pad_id)[0]
        return list(arr[: (nz[-1] + 1) if len(nz) else 0])

    def _pad(self, ids_list, length: int) -> Dict[str, np.ndarray]:
        out = np.full((len(ids_list), length), self.pad_id, np.int32)
        for r, ids in enumerate(ids_list):
            out[r, : len(ids)] = ids[:length]
        return {"input_ids": out,
                "attention_mask": (out != self.pad_id).astype(np.int32)}

    def __call__(self, texts: Sequence[str],
                 length: Optional[int] = None) -> Dict[str, np.ndarray]:
        ids_list = [self._encode_ids(t) for t in texts]
        if length is None:
            length = self.bucket_for(max((len(i) for i in ids_list),
                                         default=2))
        return self._pad(ids_list, length)

    def token_len(self, text: str) -> int:
        return len(self._encode_ids(text))

    def select_texts(self, ds: TextDataset, idx: np.ndarray,
                     rng: np.random.RandomState, strong: bool):
        """weak = 'ori'; strong = random pick of the back-translations
        (reference nlp datasetbase.py:48-60)."""
        if not strong or ds.augs is None:
            return [ds.texts[i] for i in idx]
        picks = []
        for i in idx:
            a = ds.augs[i]
            picks.append(a[rng.randint(len(a))])
        return picks

    def collate_views(self, lb: TextDataset, ulb: TextDataset,
                      li: np.ndarray, ui: np.ndarray, keys,
                      rng: np.random.RandomState,
                      length: Optional[int] = None) -> Dict:
        """All views of one step batch, jointly bucketed: every view pads to
        the same bucket so the use_cat concat path stays shape-consistent.
        View selection consumes ``rng`` key by key, as the JAX package
        does."""
        sel = {}
        for k in keys:
            if k == "x_lb":
                sel[k] = self.select_texts(lb, li, rng, strong=False)
            elif k == "x_lb_s":
                sel[k] = self.select_texts(lb, li, rng, strong=True)
            elif k in ("x_ulb_w", "x_ulb_w_2"):
                sel[k] = self.select_texts(ulb, ui, rng, strong=False)
            elif k.startswith("x_ulb_s"):
                sel[k] = self.select_texts(ulb, ui, rng, strong=True)
        enc = {k: [self._encode_ids(t) for t in v] for k, v in sel.items()}
        if length is None:
            length = self.bucket_for(max(
                (len(e) for v in enc.values() for e in v), default=2))
        return {k: self._pad(v, length) for k, v in enc.items()}


def write_synthetic_corpus(data_dir: str, name: str = "aclImdb",
                           num_classes: int = 2, seed: int = 0,
                           sizes=(("train", 2000), ("dev", 256),
                                  ("test", 64))) -> str:
    """Write a seeded JSON corpus in the aclImdb layout
    (``<data_dir>/<name>/{train,dev,test}.json``) and return its folder.

    Word counts follow IMDB reviews (lognormal, median 174 and mean ~230
    words, clipped to [10, 1000]), so most step batches of 12 texts fill the
    512-token bucket. A text of class ``c`` draws each word from ``c``'s 20
    cue words with probability 0.08 and from 5000 neutral words otherwise,
    so the label can be read from the words. ``aug_0``/``aug_1``, the strong
    views, replace 15% of the words by neutral ones. The marker ``_complete``
    is written last; a finished corpus is kept as it is."""
    base = os.path.join(data_dir, name)
    if os.path.exists(os.path.join(base, "_complete")):
        return base
    os.makedirs(base, exist_ok=True)
    rs = np.random.RandomState(seed)
    neutral = np.asarray([f"w{i}" for i in range(5000)])
    cues = np.asarray([[f"c{c}x{j}" for j in range(20)]
                       for c in range(num_classes)])

    def swap(words):
        words = words.copy()
        hit = rs.rand(len(words)) < 0.15
        words[hit] = rs.choice(neutral, int(hit.sum()))
        return " ".join(words)

    for split, count in sizes:
        d = {}
        for i in range(count):
            y = int(rs.randint(num_classes))
            n = int(np.clip(rs.lognormal(np.log(174.0), 0.75), 10, 1000))
            words = rs.choice(neutral, n)
            cue = rs.rand(n) < 0.08
            words[cue] = rs.choice(cues[y], int(cue.sum()))
            d[str(i)] = {"ori": " ".join(words), "aug_0": swap(words),
                         "aug_1": swap(words), "label": y}
        with open(os.path.join(base, f"{split}.json"), "w") as f:
            json.dump(d, f)
    open(os.path.join(base, "_complete"), "w").close()
    return base


def get_nlp_dataset(cfg, alg: str = "fixmatch"):
    """Dataset factory for aclImdb / ag_news / amazon_review / yahoo_answers /
    yelp_review / dbpedia JSON layouts."""
    splits = load_json_dataset(cfg.data_dir, cfg.dataset)
    train = splits["train"]
    rng = np.random.RandomState(cfg.seed)
    lb_idx, ulb_idx = [], []
    from semireward_tpu_torch.data.split import sample_labeled_unlabeled_data

    lb_i, ulb_i = sample_labeled_unlabeled_data(
        train.targets, cfg.num_classes, cfg.num_labels,
        ulb_num_labels=cfg.ulb_num_labels, rng=rng)
    if cfg.include_lb_to_ulb:
        ulb_i = np.concatenate([lb_i, ulb_i])

    def sub(ds, idx):
        return TextDataset([ds.texts[i] for i in idx],
                           [ds.augs[i] for i in idx] if ds.augs else None,
                           ds.targets[idx])

    return {
        "train_lb": sub(train, lb_i),
        "train_ulb": sub(train, ulb_i),
        "eval": splits["dev"],
        "test": splits["test"],
    }
