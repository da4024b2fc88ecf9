"""Bio/DNA data for the DNABERT nets (port of ``semireward_tpu/data/bio.py``,
numpy only).

CSV rows of (sequence, label) under ``<data_dir>/<name>/{train,dev,test}.csv``;
a sequence becomes its overlapping k-mers, mapped to ids by the closed-form
DNABERT vocabulary (5 special tokens, then the 4^k k-mers in lexicographic
A/C/G/T order; a k-mer with any other letter is ``[UNK]`` = 4), between
``[CLS]`` = 2 and ``[SEP]`` = 3, padded with 0 to ``max_length``. The weak
view is the sequence, the strong view its base complement (no reversal),
as in the reference's ``get_alter_of_dna_sequence``. ``BioCollator`` has
no ``collate_views``: the NLP loader pads each view by itself
(``data/modality.py:NLPSSLLoader``). ``write_synthetic_bio`` writes a
seeded corpus in that layout.
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List

import numpy as np

_BASE = {"A": 0, "C": 1, "G": 2, "T": 3}
CLS_ID, SEP_ID, PAD_ID, UNK_ID = 2, 3, 0, 4


def seq_to_kmers(seq: str, k: int = 6) -> List[str]:
    seq = seq.upper()
    return [seq[i:i + k] for i in range(len(seq) - k + 1)]


def kmer_to_id(kmer: str, k: int = 6, num_special: int = 5) -> int:
    """Closed-form DNABERT vocabulary index: the specials, then the 4^k
    k-mers in lexicographic order."""
    idx = 0
    for ch in kmer:
        if ch not in _BASE:
            return UNK_ID
        idx = idx * 4 + _BASE[ch]
    return num_special + idx


def complement(seq: str) -> str:
    """Base complement of a DNA sequence, without reversal (the strong
    view: label-preserving, content-changing)."""
    m = {"A": "T", "T": "A", "C": "G", "G": "C"}
    return "".join(m.get(c, c) for c in seq.upper())


def encode(seq: str, k: int = 6, max_length: int = 512) -> np.ndarray:
    """``[CLS] k-mer ids [SEP]``, the k-mers cut to ``max_length - 2``,
    padded to ``max_length`` (int32)."""
    kmers = seq_to_kmers(seq, k)[: max_length - 2]
    ids = [CLS_ID] + [kmer_to_id(m, k) for m in kmers] + [SEP_ID]
    out = np.full(max_length, PAD_ID, np.int32)
    out[: len(ids)] = ids
    return out


@dataclass
class DNADataset:
    seqs: List[str]
    targets: np.ndarray
    k: int = 6
    max_length: int = 512

    @property
    def data(self):
        return np.asarray(self.seqs, dtype=object)

    @property
    def texts(self):
        """The NLP pipeline's surface (the trainer's eval batches)."""
        return self.seqs

    def __len__(self):
        return len(self.seqs)

    def encode(self, idx: int) -> np.ndarray:
        return encode(self.seqs[idx], self.k, self.max_length)


def load_csv_dataset(data_dir: str, name: str, k: int = 6,
                     max_length: int = 512):
    """``{train, dev, test}`` DNADatasets of ``<data_dir>/<name>/<split>.csv``
    (a header row ``sequence``/``seq`` and short rows are skipped)."""
    base = os.path.join(data_dir, name)
    out = {}
    for split in ("train", "dev", "test"):
        seqs, ys = [], []
        with open(os.path.join(base, f"{split}.csv")) as f:
            for row in csv.reader(f):
                if len(row) < 2 or row[0] in ("sequence", "seq"):
                    continue
                seqs.append(row[0])
                ys.append(int(row[1]))
        out[split] = DNADataset(seqs, np.asarray(ys, np.int64), k, max_length)
    return out


class BioCollator:
    """k-mer tokenizing collator for the DNABERT nets, with the NLP
    collator's ``__call__`` and ``views``, every batch padded to
    ``max_length``: weak view = the sequence, strong view = its base
    complement (no draw from the ``RandomState``)."""

    def __init__(self, k: int = 6, max_length: int = 512):
        self.k = k
        self.max_length = max_length

    def __call__(self, seqs) -> dict:
        ids = np.stack([encode(s, self.k, self.max_length) for s in seqs])
        return {"input_ids": ids,
                "attention_mask": (ids != PAD_ID).astype(np.int32)}

    def views(self, ds, idx: np.ndarray, rng: np.random.RandomState,
              strong: bool) -> dict:
        seqs = [ds.seqs[i] for i in idx]
        if strong:
            seqs = [complement(s) for s in seqs]
        return self(seqs)


def get_bio_dataset(cfg, alg: str = "fixmatch"):
    """The labeled / unlabeled split of ``cfg.dataset``'s train CSV (the
    JAX package's seeded sampler), its dev split for eval and its test
    split; k-mers of ``cfg.extra['kmer']`` (default 6)."""
    from semireward_tpu_torch.data.split import sample_labeled_unlabeled_data

    k = int(cfg.extra.get("kmer", 6))
    splits = load_csv_dataset(cfg.data_dir, cfg.dataset, k=k,
                              max_length=cfg.max_length)
    train = splits["train"]
    rng = np.random.RandomState(cfg.seed)
    lb_i, ulb_i = sample_labeled_unlabeled_data(
        train.targets, cfg.num_classes, cfg.num_labels,
        ulb_num_labels=cfg.ulb_num_labels, rng=rng)
    if cfg.include_lb_to_ulb:
        ulb_i = np.concatenate([lb_i, ulb_i])

    def sub(idx):
        return DNADataset([train.seqs[i] for i in idx], train.targets[idx],
                          k, cfg.max_length)

    return {"train_lb": sub(lb_i), "train_ulb": sub(ulb_i),
            "eval": splits["dev"], "test": splits["test"]}


def write_synthetic_bio(data_dir: str, name: str = "synth_dna",
                        num_classes: int = 2, seed: int = 0,
                        sizes=(("train", 2000), ("dev", 256), ("test", 64)),
                        length=(400, 1000)) -> str:
    """Write a seeded corpus in the CSV layout
    (``<data_dir>/<name>/{train,dev,test}.csv``, a ``sequence,label``
    header) and return its folder.

    Sequences are uniform A/C/G/T of ``length`` bases (uniform; from 517
    bases at k 6 the k-mers fill a 512-token view), with one of the
    class's four 8-base motifs planted at each of ``len / 40`` random
    positions, so the label can be read from the k-mers. The marker
    ``_complete`` is written last; a finished corpus is kept as it is."""
    base = os.path.join(data_dir, name)
    if os.path.exists(os.path.join(base, "_complete")):
        return base
    os.makedirs(base, exist_ok=True)
    rs = np.random.RandomState(seed)
    letters = np.asarray(list("ACGT"))
    motifs = letters[rs.randint(0, 4, (num_classes, 4, 8))]
    for split, count in sizes:
        with open(os.path.join(base, f"{split}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["sequence", "label"])
            for i in range(count):
                y = i % num_classes if split == "train" else int(
                    rs.randint(num_classes))
                n = int(rs.randint(length[0], length[1] + 1))
                seq = letters[rs.randint(0, 4, n)]
                for pos in rs.randint(0, n - 8, n // 40):
                    seq[pos:pos + 8] = motifs[y, rs.randint(4)]
                w.writerow(["".join(seq), y])
    open(os.path.join(base, "_complete"), "w").close()
    return base
