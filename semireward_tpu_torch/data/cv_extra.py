"""The full-size JPEG-folder datasets of the port (``semi_aves``,
``food101``, ``imagenet``, ``imagenet127``; the parts of
``semireward_tpu/data/cv_extra.py`` they use): the file lists, the ImageNet
folder scan and :class:`JPEGFolderDataset`, which decodes a batch at a time
to a fixed square size.

On the CPU a batch decodes as the JAX package's PIL route does, bit for bit
(``convert("RGB")`` and a ``BILINEAR`` resize over a thread pool). On the
card it decodes through nvJPEG (``data/_nvjpeg.py``) and resizes there: the
host only reads the files, and the batch it returns lies on the card. A file
nvJPEG rejects (a PNG under a ``.JPEG`` name, a CMYK JPEG, a corrupt file)
decodes on the host for that one image and is uploaded, as the JAX package's
native route hands such files to PIL; the dataset counts them.

The regression sets (``agedb``, ``imdb_wiki``, ``rcf_mnist``; ``num_classes``
1, used with SRPseudoLabel's regression branch) read their preprocessed npz
(``load_regression_folder``), as the JAX package's do.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from semireward_tpu_torch import resolve_device

# torchvision's ImageNet constants (the reference's imagenet.py), used for
# every full-size JPEG folder dataset
MEAN_STD = {"imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))}


def load_folder_list(data_dir: str, name: str, list_file: str):
    """semi_aves / food101 style: a txt list of 'relpath label' pairs.
    Returns (paths, labels); the images decode a batch at a time."""
    base = os.path.join(data_dir, name)
    paths, ys = [], []
    with open(os.path.join(base, list_file)) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                paths.append(os.path.join(base, parts[0]))
                ys.append(int(parts[1]))
    return paths, np.asarray(ys, np.int64)


_DECODE_POOL = None


def _decode_pool():
    """The shared decode thread pool (file reads, PIL's and nvJPEG's host
    work release the GIL); None on a single-core host, where the hand-offs
    only add overhead."""
    global _DECODE_POOL
    if _DECODE_POOL is None:
        n = min(8, os.cpu_count() or 1)
        if n < 2:
            _DECODE_POOL = False
        else:
            from concurrent.futures import ThreadPoolExecutor

            _DECODE_POOL = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="jpeg-decode")
    return _DECODE_POOL or None


def decode_pil(path: str, size: int) -> np.ndarray:
    """One file -> uint8 ``[size, size, 3]``: PIL's decode, RGB, bilinear
    resize to the square (the JAX package's ``_decode_one``)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB").resize((size, size),
                                                 Image.BILINEAR))


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class JPEGFolderDataset:
    """A list of image files and their targets, decoded at ``gather`` time
    to uint8 ``[B, img_size, img_size, 3]`` (the JAX package's lazy
    image-folder dataset). ``device`` (default: the first CUDA card) picks
    the route: the CPU decodes with PIL and returns a numpy batch, the card
    decodes with nvJPEG and returns a CUDA tensor. ``decoded_on_card``
    counts the images nvJPEG decoded, ``redone_on_host`` the files it
    rejected, which were decoded with PIL instead."""

    def __init__(self, paths, targets, img_size: int = 224, device=None):
        self.paths = list(paths)
        self.targets = np.asarray(targets)
        self.img_size = img_size
        self.device = resolve_device(device)
        self.decoded_on_card = 0
        self.redone_on_host = set()
        self._nvjpeg = None

    def __len__(self):
        return len(self.paths)

    def subset(self, idx) -> "JPEGFolderDataset":
        idx = np.asarray(idx)
        return JPEGFolderDataset([self.paths[int(i)] for i in idx],
                                 self.targets[idx], self.img_size,
                                 self.device)

    def gather(self, idx):
        if self.device.type == "cuda":
            return self._gather_card([self.paths[int(i)] for i in idx])
        out = np.empty((len(idx), self.img_size, self.img_size, 3), np.uint8)

        def one(j, i):
            out[j] = decode_pil(self.paths[int(i)], self.img_size)

        pool = _decode_pool() if len(idx) > 2 else None
        if pool is None:
            for j, i in enumerate(idx):
                one(j, i)
        else:
            for f in [pool.submit(one, j, i) for j, i in enumerate(idx)]:
                f.result()  # decode errors surface, in order
        return out

    def _gather_card(self, paths):
        from semireward_tpu_torch.data._nvjpeg import (NvJpeg, resize_square,
                                                       take)

        if self._nvjpeg is None:
            self._nvjpeg = NvJpeg(self.device)
        dec, S = self._nvjpeg, self.img_size

        def one(path):
            return dec.decode(_read(path))

        pool = _decode_pool() if len(paths) > 2 else None
        imgs = list(pool.map(one, paths)) if pool else [one(p)
                                                        for p in paths]
        out = torch.empty((len(paths), S, S, 3), dtype=torch.uint8,
                          device=self.device)
        for j, (path, img) in enumerate(zip(paths, imgs)):
            if img is None:
                self.redone_on_host.add(path)
                out[j] = torch.from_numpy(decode_pil(path, S)).to(
                    self.device)
            else:
                out[j] = resize_square(take(img), S)
                self.decoded_on_card += 1
        return out


def get_imagenet(data_dir: str, img_size: int = 224, device=None):
    """The ImageNet folder layout: ``imagenet/{train,val}/<class>/*.JPEG``,
    classes numbered in name order, files in the directory's order (as the
    JAX package's ``glob``)."""

    def scan(split):
        root = os.path.join(data_dir, "imagenet", split)
        paths, ys = [], []
        for ci, c in enumerate(sorted(os.listdir(root))):
            for f in glob.glob(os.path.join(root, c, "*.JPEG")):
                paths.append(f)
                ys.append(ci)
        return JPEGFolderDataset(paths, ys, img_size, device)

    return scan("train"), scan("val")


# ---------------------------------------------------------------------------
# regression sets (the JAX package's cv_extra.py:201-218)
# ---------------------------------------------------------------------------

REGRESSION_DATASETS = ("agedb", "imdb_wiki", "rcf_mnist")


def load_regression_folder(data_dir: str, name: str):
    """``<data_dir>/<name>/<name>.npz``: ``{train,test}_x`` uint8 images
    ``[n, H, W, 3]`` and ``{train,test}_y`` targets, read as float32."""
    d = np.load(os.path.join(data_dir, name, f"{name}.npz"))
    return ((d["train_x"], d["train_y"].astype(np.float32)),
            (d["test_x"], d["test_y"].astype(np.float32)))


def load_rcf_mnist(data_dir: str):
    """RCF-MNIST (rotated coloured Fashion-MNIST, the target the rotation
    angle), from its preprocessed npz."""
    return load_regression_folder(data_dir, "rcf_mnist")
