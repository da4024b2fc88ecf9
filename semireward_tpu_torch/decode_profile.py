"""The JPEG-folder datasets' decode rate on one CUDA card.

    python -m semireward_tpu_torch.decode_profile [--size 256]
        [--images 512] [--threads 1 2 4 8]

Writes the seeded ImageNet-layout folder of the ViT-B/16 smoke phase
(``build/synth_imagenet``: 1000 classes, 4096 + 256 images of 200-500 px)
if it is not there, then times ``JPEGFolderDataset.gather`` of ``--images``
train images at ``--size`` px (the second of two gathers of the same files:
warm file cache, nvJPEG's states made): on the card with the decode pool at
each ``--threads`` count, once more with every thread decoding on the
default stream instead of its own, once with an nvJPEG handle a thread
instead of one shared, and the CPU route (PIL) on the default decode pool.
Prints one JSON object with images/s of each and the card's name and power
limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from semireward_tpu_torch.data import _nvjpeg, cv_extra


class _HandleAThread:
    """``NvJpeg.decode`` through a handle of the calling thread's own."""

    def __init__(self, device):
        self.device, self._local = device, threading.local()

    def decode(self, data):
        dec = getattr(self._local, "dec", None)
        if dec is None:
            dec = self._local.dec = _nvjpeg.NvJpeg(self.device)
        return dec.decode(data)


def _rate(ds, idx) -> float:
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds.gather(idx)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return len(idx) / secs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--images", type=int, default=512)
    p.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile: no CUDA device")
    from semireward_tpu_torch.data.datasets import write_synthetic_jpeg_folder
    from semireward_tpu_torch.profile_step import SYNTH_JPEG

    root = write_synthetic_jpeg_folder(SYNTH_JPEG["imagenet"], 1000, 4096,
                                       256)
    idx = np.random.RandomState(0).choice(4096, args.images, replace=False)
    out = {"size": args.size, "images": args.images, "card_images_per_s": {},
           "card_default_stream_images_per_s": {},
           "card_handle_a_thread_images_per_s": {}}
    own_stream = _nvjpeg.NvJpeg._stream
    try:
        for n in args.threads:
            pool = ThreadPoolExecutor(n) if n > 1 else None
            cv_extra._DECODE_POOL = pool or False
            for key, stream in (("card_images_per_s", own_stream),
                                ("card_default_stream_images_per_s",
                                 lambda self: torch.cuda.default_stream(
                                     self.device))):
                _nvjpeg.NvJpeg._stream = stream
                card, _ = cv_extra.get_imagenet(root, args.size, "cuda")
                out[key][n] = _rate(card, idx)
            _nvjpeg.NvJpeg._stream = own_stream
            card, _ = cv_extra.get_imagenet(root, args.size, "cuda")
            card._nvjpeg = _HandleAThread(card.device)
            out["card_handle_a_thread_images_per_s"][n] = _rate(card, idx)
            if pool is not None:
                pool.shutdown()
        _nvjpeg.NvJpeg._stream = own_stream
        cv_extra._DECODE_POOL = None  # the default pool
        host, _ = cv_extra.get_imagenet(root, args.size, "cpu")
        out["cpu_images_per_s"] = _rate(host, idx)
    finally:
        _nvjpeg.NvJpeg._stream = own_stream
        cv_extra._DECODE_POOL = None
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
