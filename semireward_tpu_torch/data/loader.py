"""Host-side batching (the parts of ``semireward_tpu/data/loader.py`` the
headline path uses): seeded infinite samplers yielding raw uint8 batches,
fixed-shape eval batches, and the prefetch thread. numpy only, copied so
both packages draw the same index streams for the same seed. A JPEG-folder
dataset's ``gather`` decodes its batch, on the card where the dataset lives
there (a CUDA tensor, passed on as it is). The native row gather is not
ported yet (ROADMAP).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from semireward_tpu_torch.data.datasets import ArrayDataset, SSLDataBundle


def infinite_indices(n: int, seed: int, rank: int = 0, world: int = 1
                     ) -> Iterator[int]:
    """Repeated seeded randperm, strided by rank (sampler.py:59-77)."""
    if world > 1 and n < world:
        raise ValueError(
            f"dataset of {n} rows cannot stride over {world} hosts "
            f"(the epoch loop would yield nothing and next() would spin "
            f"forever)")
    g = np.random.RandomState(seed)
    while True:
        perm = g.permutation(n)
        for i in range(rank, n - (n % world or 0) if world > 1 else n, world):
            yield perm[i]


def _class_balance_weights(targets, num_classes: int) -> np.ndarray:
    """Inverse-class-frequency sampling weights, normalized. A regression
    set's float targets have no classes to balance: they raise."""
    if np.issubdtype(np.asarray(targets).dtype, np.floating):
        raise ValueError("class-balanced sampling needs integer class "
                         "labels; a regression set's targets are floats")
    targets = np.asarray(targets, np.int64)
    cnt = np.bincount(targets, minlength=num_classes).astype(np.float64)
    w = (1.0 / np.maximum(cnt, 1))[targets]
    return w / w.sum()


def batched(it: Iterator[int], batch_size: int) -> Iterator[np.ndarray]:
    buf = []
    for i in it:
        buf.append(i)
        if len(buf) == batch_size:
            yield np.asarray(buf)
            buf = []


class SSLLoader:
    """Yields raw (undecoded, unaugmented) SSL batches:
    {x_lb, y_lb, idx_lb, x_ulb, y_ulb, idx_ulb} as numpy arrays. Device-side
    augmentation turns x_ulb into the weak/strong views on the device."""

    def __init__(self, bundle: SSLDataBundle, batch_size: int,
                 ulb_batch_size: int, seed: int = 0, rank: int = 0,
                 world: int = 1, tfe_streams: bool = False,
                 tfe_ulb_batch_size: int = 0, sampler: str = "RandomSampler"):
        self.bundle = bundle
        self.batch_size = batch_size
        self.ulb_batch_size = ulb_batch_size
        if sampler == "WeightedRandomSampler":
            # name2sampler's weighted variant (reference
            # datasets/samplers/sampler.py:148): labeled stream reweighted
            # toward class balance. Drawn a BATCH at a time — a per-index
            # rs.choice(p=w) rebuilds the O(N) CDF every draw
            w = _class_balance_weights(bundle.train_lb.targets,
                                       bundle.num_classes)
            rs = np.random.RandomState(seed + 1000 * rank)
            n_lb = len(bundle.train_lb)

            def weighted_batches():
                while True:
                    yield rs.choice(n_lb, batch_size, p=w)

            self._lb = weighted_batches()
        else:
            self._lb = batched(
                infinite_indices(len(bundle.train_lb), seed, rank, world),
                batch_size)
        self._ulb = batched(
            infinite_indices(len(bundle.train_ulb), seed + 1, rank, world),
            ulb_batch_size)
        # CoSSL TFE streams: class-balanced labeled (weighted toward uniform,
        # reference cossl.py:150-160) + an extra unlabeled stream
        self._tfe = None
        if tfe_streams:
            self._tfe_p = _class_balance_weights(bundle.train_lb.targets,
                                                 bundle.num_classes)
            self._tfe_rs = np.random.RandomState(seed + 7 + 1000 * rank)
            self._tfe_ulb = batched(
                infinite_indices(len(bundle.train_ulb), seed + 8, rank, world),
                tfe_ulb_batch_size or batch_size)
            self._tfe = True

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        lb_idx = next(self._lb)
        ulb_idx = next(self._ulb)
        lb, ulb = self.bundle.train_lb, self.bundle.train_ulb

        def fetch(ds, idx):
            # lazy-decode datasets (JPEG folders) expose gather(); in-RAM
            # datasets take the (native-threaded) row gather. Dispatch is
            # PER DATASET — a bundle can mix the two (e.g. a small in-RAM
            # labeled split over a folder-backed unlabeled set).
            if hasattr(ds, "gather"):
                return ds.gather(idx)
            return ds.data[idx]

        out = {
            "x_lb": fetch(lb, lb_idx),
            "y_lb": lb.targets[lb_idx],
            "idx_lb": lb_idx.astype(np.int32),
            "x_ulb": fetch(ulb, ulb_idx),
            "y_ulb": ulb.targets[ulb_idx],
            "idx_ulb": ulb_idx.astype(np.int32),
        }
        if self._tfe:
            # CoSSL's teacher streams must flow on JPEG-folder datasets
            # too — silently dropping them degrades CoSSL to its base
            # algorithm (cossl.post_loss skips when x_tfe_lb is absent)
            tfe_lb_idx = self._tfe_rs.choice(len(lb), self.batch_size,
                                             p=self._tfe_p)
            tfe_ulb_idx = next(self._tfe_ulb)
            out["x_tfe_lb"] = fetch(lb, tfe_lb_idx)
            out["y_tfe_lb"] = lb.targets[tfe_lb_idx]
            out["x_tfe_ulb"] = fetch(ulb, tfe_ulb_idx)
        return out


def eval_batches(ds: ArrayDataset, batch_size: int):
    """Fixed-shape eval batches; last batch padded (by repeating its last
    image; a JPEG set's batch may be a CUDA tensor), with a validity mask
    so every batch has one shape."""
    n = len(ds)
    lazy = hasattr(ds, "gather")  # JPEG folder datasets decode per batch
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        x = (ds.gather(np.arange(start, stop)) if lazy
             else ds.data[start:stop])
        y = ds.targets[start:stop]
        pad = batch_size - (stop - start)
        mask = np.ones(batch_size, bool)
        if pad:
            x = (torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
                 if isinstance(x, torch.Tensor)
                 else np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]))
            y = np.concatenate([y, np.repeat(y[-1:], pad, axis=0)])
            mask[stop - start:] = False
        yield {"x": x, "y": y, "mask": mask}


class PrefetchLoader:
    """Background-thread prefetch over any (infinite) batch iterator (copy
    of the JAX package's).

    Overlaps host-side batch assembly (JPEG decode, row gather, collate)
    with device steps: a single producer thread fills a bounded FIFO
    queue, so batch order — and therefore run reproducibility — is
    unchanged. The consumer blocks only when the queue is empty; that
    wait is the true loader-starvation signal surfaced as
    ``train/prefetch_time`` (the analogue of the reference TimerHook's
    metric, core/hooks/timer.py:13-27). Producer exceptions re-raise on
    the consumer side. The wrapped loader draws from no torch generator
    (the trainer's device copies and augmentation stay on the main thread,
    in stream order); its only CUDA work is a JPEG set's decode on the
    card, whose batch it passes on as it is, ordered before the step that
    reads it by the one default stream both threads launch on."""

    def __init__(self, loader, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thr = threading.Thread(target=self._run, args=(loader,),
                                     name="batch-prefetch", daemon=True)
        self._thr.start()

    _END = object()  # producer-exhausted sentinel (finite wrapped loaders)

    def _run(self, loader):
        import queue

        try:
            for b in loader:
                while not self._stop.is_set():
                    try:
                        self._q.put(b, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            while not self._stop.is_set():  # finite loader drained
                try:
                    self._q.put(self._END, timeout=0.25)
                    break
                except queue.Full:
                    continue
        except BaseException as e:  # surface on the consumer thread
            # bounded, stop-aware put: an unconditional blocking put would
            # hang this daemon thread forever if the consumer already
            # close()d after its own error (queue full, nobody draining)
            while not self._stop.is_set():
                try:
                    self._q.put(e, timeout=0.25)
                    break
                except queue.Full:
                    try:  # drop one stale batch to make room for the error
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self, timeout: float = 120.0):
        """Stop the producer and wait until it has finished the batch it
        is assembling: a JPEG set decodes that batch on the card, and a
        daemon thread still inside PyTorch when the interpreter exits
        aborts the process."""
        self._stop.set()
        self._thr.join(timeout)
