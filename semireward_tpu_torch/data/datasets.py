"""Datasets of the port (the parts of ``semireward_tpu/data/datasets.py``
and ``data/cv_extra.py`` the ported paths use): raw uint8 arrays in host
memory; CIFAR-10/100, SVHN and STL-10 from their local torchvision file
layouts, EuroSAT and TissueMNIST from their npz files, and the seeded
synthetic tasks (blobs, and the rotation orbit of the golden-learning
checks); the full-size JPEG folders (``imagenet``, ``imagenet127``,
``food101``, ``semi_aves``) decode a batch at a time (``data/cv_extra.py``),
on the card unless the caller asks for the CPU. numpy (and scipy for SVHN's
.mat) only, copied so that both packages produce the same arrays and splits
for the same seed. Augmentation runs on the device (``data/augment``).
The regression sets (``agedb``, ``imdb_wiki``, ``rcf_mnist``: float32
targets, ``num_classes`` 1) read their npz (``data/cv_extra.py``).
Loaders read local files only; ``write_synthetic_stl10``,
``write_synthetic_regression`` and ``write_synthetic_jpeg_folder`` write
seeded corpora in the layouts they read.
"""
from __future__ import annotations

import math
import os
import pickle
import shutil
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from semireward_tpu_torch.data.cv_extra import (REGRESSION_DATASETS,
                                               load_regression_folder)
from semireward_tpu_torch.data.split import split_ssl_data

# per-dataset normalization constants (reference cifar.py:16-21, svhn.py,
# stl10.py)
MEAN = {
    "cifar10": (0.485, 0.456, 0.406),
    "cifar100": tuple(x / 255 for x in (129.3, 124.1, 112.4)),
    "synthetic": (0.5, 0.5, 0.5),
}
STD = {
    "cifar10": (0.229, 0.224, 0.225),
    "cifar100": tuple(x / 255 for x in (68.2, 65.4, 70.4)),
    "synthetic": (0.25, 0.25, 0.25),
}
# reference svhn.py / stl10.py / eurosat.py / medmnist.py constants
MEAN_STD = {
    "svhn": ((0.4380, 0.4440, 0.4730), (0.1751, 0.1771, 0.1744)),
    "stl10": ((112.4 / 255, 109.1 / 255, 98.6 / 255),
              (68.4 / 255, 66.6 / 255, 68.5 / 255)),
    "eurosat": ((0.3442, 0.3802, 0.4077), (0.2025, 0.1369, 0.1156)),
    "tissuemnist": ((0.5,) * 3, (0.5,) * 3),  # grayscale, repeated to RGB
}


# the names get_dataset reads
JPEG_DATASETS = ("imagenet", "imagenet127", "food101", "semi_aves")
CV_DATASETS = ("cifar10", "cifar100", "svhn", "stl10", "eurosat",
               "tissuemnist", "medmnist", "synthetic", "synthetic_orbit",
               *JPEG_DATASETS, *REGRESSION_DATASETS)


@dataclass
class ArrayDataset:
    """Raw array dataset: images uint8 [N,H,W,C], integer (or float) targets."""

    data: np.ndarray
    targets: np.ndarray

    def __len__(self):
        return len(self.data)


@dataclass
class SSLDataBundle:
    train_lb: ArrayDataset
    train_ulb: ArrayDataset
    eval: ArrayDataset
    num_classes: int
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]

    @property
    def ulb_dest_len(self) -> int:
        return len(self.train_ulb)

    @property
    def lb_dest_len(self) -> int:
        return len(self.train_lb)


def _load_cifar10(data_dir: str):
    base = os.path.join(data_dir, "cifar10", "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = os.path.join(data_dir, "cifar-10-batches-py")
    xs, ys = [], []
    for name in [f"data_batch_{i}" for i in range(1, 6)]:
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        xs.append(d["data"])
        ys.extend(d["labels"])
    train = (np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
             np.asarray(ys, np.int64))
    with open(os.path.join(base, "test_batch"), "rb") as f:
        d = pickle.load(f, encoding="latin1")
    test = (np.asarray(d["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
            np.asarray(d["labels"], np.int64))
    return train, test


def _load_cifar100(data_dir: str):
    base = os.path.join(data_dir, "cifar100", "cifar-100-python")
    if not os.path.isdir(base):
        base = os.path.join(data_dir, "cifar-100-python")
    out = []
    for name in ("train", "test"):
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="latin1")
        out.append((np.asarray(d["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                    np.asarray(d["fine_labels"], np.int64)))
    return out[0], out[1]


def load_svhn(data_dir: str):
    """torchvision SVHN .mat layout (``svhn/{train,test}_32x32.mat``): X is
    HWCN, label 10 is digit 0."""
    from scipy.io import loadmat

    out = []
    for split in ("train", "test"):
        m = loadmat(os.path.join(data_dir, "svhn", f"{split}_32x32.mat"))
        x = np.transpose(m["X"], (3, 0, 1, 2))
        out.append((x, m["y"].reshape(-1).astype(np.int64) % 10))
    return out[0], out[1]


def load_stl10(data_dir: str):
    """torchvision STL-10 binary layout (``stl10_binary/*.bin``, 96 px,
    column-major CWH images, labels 1-10). Returns ``((train_x, train_y),
    (test_x, test_y), unlabeled_x)``."""
    base = os.path.join(data_dir, "stl10", "stl10_binary")
    if not os.path.isdir(base):
        base = os.path.join(data_dir, "stl10_binary")

    def images(name):
        with open(os.path.join(base, name), "rb") as f:
            x = np.frombuffer(f.read(), np.uint8)
        return x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)

    def labels(name):
        with open(os.path.join(base, name), "rb") as f:
            return np.frombuffer(f.read(), np.uint8).astype(np.int64) - 1

    return ((images("train_X.bin"), labels("train_y.bin")),
            (images("test_X.bin"), labels("test_y.bin")),
            images("unlabeled_X.bin"))


def write_synthetic_stl10(data_dir: str, seed: int = 0,
                          sizes=(("train", 500), ("test", 256),
                                 ("unlabeled", 1024))) -> str:
    """Write a seeded corpus in the STL-10 binary layout that
    :func:`load_stl10` reads (``<data_dir>/stl10/stl10_binary/*.bin``: 96
    px images, column-major CWH, labels 1-10) and return its folder. An
    image of class ``c`` is ``c``'s prototype (8 x 8 colour blocks blown up
    to 96 px) plus uniform noise of +-40; the train split cycles through the
    classes, the others draw them. The marker ``_complete`` is written
    last; a finished corpus is kept as it is."""
    base = os.path.join(data_dir, "stl10", "stl10_binary")
    if os.path.exists(os.path.join(base, "_complete")):
        return base
    os.makedirs(base, exist_ok=True)
    rs = np.random.RandomState(seed)
    protos = np.repeat(np.repeat(rs.randint(0, 256, (10, 8, 8, 3)), 12,
                                 axis=1), 12, axis=2)
    for split, n in sizes:
        y = (np.arange(n) % 10 if split == "train"
             else rs.randint(0, 10, n))
        x = np.clip(protos[y] + rs.randint(-40, 40, (n, 96, 96, 3)), 0,
                    255).astype(np.uint8)
        with open(os.path.join(base, f"{split}_X.bin"), "wb") as f:
            f.write(np.ascontiguousarray(x.transpose(0, 3, 2, 1)).tobytes())
        if split != "unlabeled":
            with open(os.path.join(base, f"{split}_y.bin"), "wb") as f:
                f.write((y + 1).astype(np.uint8).tobytes())
    open(os.path.join(base, "_complete"), "w").close()
    return base


def write_synthetic_regression(data_dir: str, name: str = "agedb",
                               seed: int = 0, n_train: int = 512,
                               n_test: int = 128, size: int = 224) -> str:
    """Write a seeded corpus in the npz layout of
    ``cv_extra.load_regression_folder`` (``<data_dir>/<name>/<name>.npz``:
    uint8 ``[n, size, size, 3]`` images, float32 targets uniform in [1,
    101), AgeDB's age range) and return its path. An image is uniform
    noise blended half and half with a grey level that grows with its
    target, so the target can be learned. A finished file is kept as it
    is."""
    path = os.path.join(data_dir, name, f"{name}.npz")
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rs = np.random.RandomState(seed)
    arrays = {}
    for split, n in (("train", n_train), ("test", n_test)):
        y = rs.uniform(1.0, 101.0, n).astype(np.float32)
        x = np.empty((n, size, size, 3), np.uint8)
        for i in range(n):
            level = y[i] / 101.0 * 255.0
            x[i] = (0.5 * rs.randint(0, 256, (size, size, 3))
                    + 0.5 * level).astype(np.uint8)
        arrays[f"{split}_x"], arrays[f"{split}_y"] = x, y
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


_NOISE = {}


def _noise_tile(seed: int):
    """The luminance noise of a seeded JPEG folder: a 500 x 500 gray tile
    of +-12 about 128, as an RGB image (drawn once a process)."""
    from PIL import Image

    if seed not in _NOISE:
        rs = np.random.RandomState([seed, 1 << 30])
        _NOISE[seed] = Image.fromarray(np.repeat(
            rs.randint(116, 141, (500, 500, 1)), 3, 2).astype(np.uint8))
    return _NOISE[seed]


def _synthetic_jpeg(args):
    """Write image ``i`` of a seeded JPEG folder (see
    :func:`write_synthetic_jpeg_folder`)."""
    from PIL import Image, ImageChops

    path, proto, seed, i = args
    rs = np.random.RandomState([seed, i])
    h = rs.randint(200, 501)
    w = int(np.clip(round(h * np.exp(rs.uniform(np.log(3 / 4),
                                                 np.log(4 / 3)))), 200, 500))
    low = np.clip(proto + rs.randint(-30, 31, proto.shape), 0, 255)
    base = Image.fromarray(low.astype(np.uint8)).resize((w, h),
                                                        Image.BILINEAR)
    noise = _noise_tile(seed)
    oy, ox = rs.randint(0, noise.height - h + 1), rs.randint(
        0, noise.width - w + 1)
    ImageChops.add(base, noise.crop((ox, oy, ox + w, oy + h)),
                   offset=-128).save(path, "JPEG", quality=90)


def write_synthetic_jpeg_folder(data_dir: str, num_classes: int,
                                n_train: int, n_val: int,
                                seed: int = 0) -> str:
    """Write a seeded corpus in the ImageNet folder layout that
    ``cv_extra.get_imagenet`` reads (``<data_dir>/imagenet/{train,val}/
    <class>/*.JPEG``, class ``c`` named ``n%08d``) and return ``data_dir``.
    Images have ImageNet's sides (each 200-500 px, aspect 3:4 to 4:3) at
    JPEG quality 90, 4:2:0: image ``i`` of class ``c`` is ``c``'s
    prototype (4 x 4 colour blocks, each moved by up to +-30) blown up
    bilinearly, plus luminance noise of +-12, drawn from ``(seed, i)``;
    train and val cycle through the classes. As in ImageNet's train set,
    class 0's train folder also holds a grayscale JPEG, a CMYK JPEG and a
    PNG under a ``.JPEG`` name (``planted_{gray,cmyk,png}.JPEG``). From
    512 images on, a process a core writes them (threads did not scale).
    The marker ``imagenet/_complete``, written last, holds the arguments; a
    finished corpus of the same arguments is kept as it is."""
    import json
    from PIL import Image

    root = os.path.join(data_dir, "imagenet")
    marker = os.path.join(root, "_complete")
    spec = json.dumps([num_classes, n_train, n_val, seed])
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == spec:
                return data_dir
    shutil.rmtree(root, ignore_errors=True)
    rs = np.random.RandomState(seed)
    protos = rs.randint(0, 256, (num_classes, 4, 4, 3)).astype(np.uint8)
    jobs = []
    for split, n, off in (("train", n_train, 0), ("val", n_val, n_train)):
        for c in range(num_classes):
            os.makedirs(os.path.join(root, split, f"n{c:08d}"))
        for i in range(n):
            c = i % num_classes
            jobs.append((os.path.join(root, split, f"n{c:08d}",
                                      f"n{c:08d}_{i}.JPEG"),
                         protos[c], seed, off + i))
    procs = min(8, os.cpu_count() or 1, len(jobs) // 512)
    if procs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(procs, multiprocessing.get_context(
                "spawn")) as ex:
            list(ex.map(_synthetic_jpeg, jobs, chunksize=64))
    else:
        for job in jobs:
            _synthetic_jpeg(job)
    # the files a JPEG decoder may reject, as ImageNet's train set has them
    planted = Image.fromarray(np.repeat(np.repeat(protos[0], 75, 0), 100, 1))
    cls0 = os.path.join(root, "train", f"n{0:08d}")
    planted.convert("L").save(os.path.join(cls0, "planted_gray.JPEG"),
                              "JPEG", quality=90)
    planted.convert("CMYK").save(os.path.join(cls0, "planted_cmyk.JPEG"),
                                 "JPEG", quality=90)
    planted.save(os.path.join(cls0, "planted_png.JPEG"), "PNG")
    with open(marker, "w") as f:
        f.write(spec)
    return data_dir


def load_eurosat(data_dir: str):
    """EuroSAT RGB, preprocessed to ``eurosat/eurosat.npz`` (train_x,
    train_y, test_x, test_y)."""
    d = np.load(os.path.join(data_dir, "eurosat", "eurosat.npz"))
    return ((d["train_x"], d["train_y"].astype(np.int64)),
            (d["test_x"], d["test_y"].astype(np.int64)))


def load_medmnist(data_dir: str, name: str = "tissuemnist"):
    """MedMNIST npz layout (``medmnist/<name>.npz`` or ``<name>.npz``, keys
    ``{train,val,test}_{images,labels}``); grayscale repeated to 3
    channels."""
    path = os.path.join(data_dir, "medmnist", f"{name}.npz")
    if not os.path.isfile(path):
        path = os.path.join(data_dir, f"{name}.npz")
    d = np.load(path)

    def split(s):
        x = np.asarray(d[f"{s}_images"])
        if x.ndim == 3:
            x = np.repeat(x[..., None], 3, axis=-1)
        return x, np.asarray(d[f"{s}_labels"]).reshape(-1).astype(np.int64)

    return split("train"), split("val"), split("test")


def make_synthetic(num_classes: int, img_size: int, n_train: int = 512,
                   n_test: int = 128, seed: int = 0, noise: int = 40,
                   class_sim: float = 0.0, proto_scale: int = 0):
    """Class-conditional gaussian-blob images — deterministic, learnable,
    no files needed. Used by tests and the throughput benchmark. ``noise``
    controls per-sample difficulty; ``class_sim`` in [0,1) mixes a SHARED
    global pattern into every class prototype (prototype = class_sim * G +
    (1 - class_sim) * P_c), compressing inter-class margins so clusters
    OVERLAP under the same noise — the golden-benchmark headroom knob
    (VERDICT r2 item 1): with few labels the labeled-only boundary is far
    from optimal while the unlabeled cluster density still defines the
    classes. ``proto_scale=k`` draws prototypes on a kxk grid upsampled to
    img_size — LOW-FREQUENCY patterns that survive RandAugment's geometric
    ops (a crop/rotation of an iid-pixel pattern is decorrelated from the
    prototype, so consistency training on a hard iid task optimizes pure
    noise; real images are low-frequency, and so must the golden task be).
    class_sim=0, proto_scale=0 reproduces the round-1/2 task
    byte-for-byte."""
    rs = np.random.RandomState(seed)
    # one shared set of class prototypes for BOTH splits (the whole point
    # of a learnable synthetic task)
    if proto_scale:
        rep = img_size // proto_scale
        small = rs.randint(0, 256, (num_classes, proto_scale, proto_scale, 3))
        base = np.repeat(np.repeat(small, rep, axis=1), rep, axis=2)
    else:
        base = rs.randint(0, 256, (num_classes, img_size, img_size, 3))
    if class_sim > 0.0:
        if proto_scale:
            gs = rs.randint(0, 256, (1, proto_scale, proto_scale, 3))
            rep = img_size // proto_scale
            g = np.repeat(np.repeat(gs, rep, axis=1), rep, axis=2)
        else:
            g = rs.randint(0, 256, (1, img_size, img_size, 3))
        base = np.clip(class_sim * g + (1.0 - class_sim) * base,
                       0, 255).astype(np.int64)

    def gen(n):
        y = rs.randint(0, num_classes, n)
        # noise=0 must be legal (clean-task probes): randint(low>=high)
        # raises. The asymmetric [-noise, noise) range is kept as-is —
        # committed round-2 QUALITY artifacts calibrated on this stream
        eps = (rs.randint(-noise, noise, (n, img_size, img_size, 3))
               if noise > 0 else 0)
        x = np.clip(base[y] + eps, 0, 255).astype(np.uint8)
        return x, y.astype(np.int64)

    return gen(n_train), gen(n_test)


def make_synthetic_orbit(num_classes: int, img_size: int, n_lb: int,
                         n_ulb: int = 2048, n_test: int = 512, seed: int = 0,
                         noise: int = 40, rot_lab: float = 10.0,
                         rot_max: float = 90.0, proto_scale: int = 4):
    """The golden-learning task (``validation.py``): a rotation orbit with
    a coverage gap the labels cannot close alone. Each class prototype
    arranges one shared palette of ``proto_scale**2`` colours in a
    class-specific order (every pixelwise statistic is the same across
    classes; only the arrangement, which rotation scrambles, carries the
    label), blown up to ``img_size``. Labeled images are rotated by angles
    in [0, ``rot_lab``] degrees, unlabeled and eval images in [0,
    ``rot_max``]: a labeled-only model is right only near the labeled
    wedge, while consistency training carries the labels out along the
    unlabeled orbit. The palette and arrangements are fixed (seed 1234);
    ``seed`` varies the sampling and noise. Returns ``(lb, ulb, eval)``,
    each ``(uint8 [n, H, W, 3], int64 [n])``; the labeled split cycles
    through the classes."""
    rs_geom = np.random.RandomState(1234)
    k = proto_scale
    palette = rs_geom.randint(0, 256, (k * k, 3))
    protos = np.stack([
        palette[rs_geom.permutation(k * k)].reshape(k, k, 3)
        for _ in range(num_classes)])
    rep = img_size // k
    protos = np.repeat(np.repeat(protos, rep, axis=1), rep, axis=2)
    protos = protos.astype(np.float32)
    rs = np.random.RandomState(seed)

    c = (img_size - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(img_size, dtype=np.float32),
                         np.arange(img_size, dtype=np.float32), indexing="ij")

    def gen(n, lo, hi, balanced=False):
        if balanced:
            if n % num_classes:
                raise ValueError(f"{n} labels do not split evenly over "
                                 f"{num_classes} classes")
            y = np.tile(np.arange(num_classes), n // num_classes)
        else:
            y = rs.randint(0, num_classes, n)
        th = np.deg2rad(rs.uniform(lo, hi, n).astype(np.float32))
        cs, sn = np.cos(th)[:, None, None], np.sin(th)[:, None, None]
        # inverse-map nearest-neighbour rotation about the centre, clamped
        # at the edges (the blocky prototype continues its border blocks)
        ys = c + (yy - c) * cs - (xx - c) * sn
        xs = c + (yy - c) * sn + (xx - c) * cs
        yc = np.clip(np.rint(ys).astype(np.int64), 0, img_size - 1)
        xc = np.clip(np.rint(xs).astype(np.int64), 0, img_size - 1)
        x = protos[y[:, None, None], yc, xc]
        eps = rs.randint(-noise, noise + 1, x.shape)
        x = np.clip(x + eps, 0, 255).astype(np.uint8)
        return x, y.astype(np.int64)

    lb = gen(n_lb, 0.0, rot_lab, balanced=True)
    ulb = gen(n_ulb, 0.0, rot_max)
    ev = gen(n_test, 0.0, rot_max)
    return lb, ulb, ev


def _jpeg_bundle(cfg, device) -> SSLDataBundle:
    """The full-size JPEG folder datasets (the JAX package's
    ``get_dataset`` branch, datasets.py:320-376): images decode at
    ``floor(img_size / crop_ratio)`` and the views crop ``img_size`` out of
    that (``AugmentSpec.src_size``; eval center-crops). ``semi_aves`` reads
    its predefined labeled / unlabeled / val lists; ``food101`` its train
    and test lists and ``imagenet`` / ``imagenet127`` their folders (the
    same loader: an imagenet127 tree holds its 127 coarse class folders),
    then the labeled indices are drawn as for the array datasets, dumped
    under ``data_statistics``."""
    from semireward_tpu_torch.data.cv_extra import (
        MEAN_STD as JPEG_MEAN_STD, JPEGFolderDataset, get_imagenet,
        load_folder_list)
    from semireward_tpu_torch.data.split import sample_labeled_unlabeled_data

    name = cfg.dataset
    mean, std = JPEG_MEAN_STD["imagenet"]
    decode = int(math.floor(cfg.img_size / cfg.crop_ratio))
    if name == "semi_aves":
        def first(*cands):
            for c in cands:
                if os.path.isfile(os.path.join(cfg.data_dir, name, c)):
                    return load_folder_list(cfg.data_dir, name, c)
            raise FileNotFoundError(
                f"{name}: none of {cands} under {cfg.data_dir}/{name}")

        sets = [JPEGFolderDataset(*first(*cands), decode, device)
                for cands in (("l_train_val.txt", "l_train.txt"),
                              ("u_train_in.txt", "u_train.txt"),
                              ("val.txt", "test.txt"))]
        return SSLDataBundle(*sets, num_classes=cfg.num_classes, mean=mean,
                             std=std)
    if name == "food101":
        train = JPEGFolderDataset(*load_folder_list(
            cfg.data_dir, name, "train_list.txt"), decode, device)
        val = JPEGFolderDataset(*load_folder_list(
            cfg.data_dir, name, "test_list.txt"), decode, device)
    else:
        train, val = get_imagenet(cfg.data_dir, decode, device)
    lb_idx, ulb_idx = sample_labeled_unlabeled_data(
        np.asarray(train.targets), cfg.num_classes, cfg.num_labels,
        ulb_num_labels=cfg.ulb_num_labels,
        lb_imbalance_ratio=cfg.lb_imb_ratio,
        ulb_imbalance_ratio=cfg.ulb_imb_ratio,
        rng=np.random.RandomState(cfg.seed),
        dump_dir=os.path.join(cfg.data_dir, "data_statistics", name,
                              "labeled_idx"),
        dump_tag=f"labels{cfg.num_labels}_{cfg.lb_imb_ratio}"
                 f"_ulb{cfg.ulb_num_labels}_{cfg.ulb_imb_ratio}"
                 f"_seed{cfg.seed}")
    if cfg.include_lb_to_ulb:
        ulb_idx = np.concatenate([lb_idx, ulb_idx])
    return SSLDataBundle(
        train_lb=train.subset(lb_idx), train_ulb=train.subset(ulb_idx),
        eval=val, num_classes=cfg.num_classes, mean=mean, std=std)


def get_dataset(cfg, alg: str = "fixmatch", device=None) -> SSLDataBundle:
    """Dataset-name dispatch: cifar10, cifar100, svhn, stl10, eurosat,
    tissuemnist (local files), synthetic and synthetic_orbit, the
    full-size JPEG folders (``JPEG_DATASETS``), which decode on ``device``
    (default: the first CUDA card), and the regression sets
    (``REGRESSION_DATASETS``). The other datasets of the JAX package are
    not ported yet (ROADMAP)."""
    name = cfg.dataset
    if name in JPEG_DATASETS:
        return _jpeg_bundle(cfg, device)
    if name in REGRESSION_DATASETS:
        # float targets, num_classes 1: the labeled set is the first
        # num_labels of a seeded permutation (no classes to balance)
        (data, targets), (tdata, ttargets) = load_regression_folder(
            cfg.data_dir, name)
        perm = np.random.RandomState(cfg.seed).permutation(len(data))
        lb_idx = perm[:cfg.num_labels]
        ulb_idx = perm if cfg.include_lb_to_ulb else perm[cfg.num_labels:]
        return SSLDataBundle(
            train_lb=ArrayDataset(data[lb_idx], targets[lb_idx]),
            train_ulb=ArrayDataset(data[ulb_idx], targets[ulb_idx]),
            eval=ArrayDataset(tdata, ttargets), num_classes=1,
            mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
    if name in ("cifar10", "cifar100"):
        loader = _load_cifar10 if name == "cifar10" else _load_cifar100
        try:
            (data, targets), (tdata, ttargets) = loader(cfg.data_dir)
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                f"{name} not found under {cfg.data_dir} (place the "
                f"torchvision-extracted files there, or use "
                f"dataset='synthetic')") from e
        mean, std = MEAN[name], STD[name]
        num_classes = 10 if name == "cifar10" else 100
    elif name == "svhn":
        (data, targets), (tdata, ttargets) = load_svhn(cfg.data_dir)
        mean, std = MEAN_STD["svhn"]
        num_classes = 10
    elif name == "stl10":
        # the labeled split comes from train; the dedicated unlabeled set
        # is the ulb set
        (data, targets), (tdata, ttargets), unlabeled = load_stl10(
            cfg.data_dir)
        lb_data, lb_targets, _, _ = split_ssl_data(
            data, targets, 10, cfg.num_labels, include_lb_to_ulb=False,
            rng=np.random.RandomState(cfg.seed))
        ulb = (np.concatenate([lb_data, unlabeled], 0)
               if cfg.include_lb_to_ulb else unlabeled)
        return SSLDataBundle(
            train_lb=ArrayDataset(lb_data, lb_targets),
            train_ulb=ArrayDataset(ulb, np.full(len(ulb), -1, np.int64)),
            eval=ArrayDataset(tdata, ttargets), num_classes=10,
            mean=MEAN_STD["stl10"][0], std=MEAN_STD["stl10"][1])
    elif name == "eurosat":
        (data, targets), (tdata, ttargets) = load_eurosat(cfg.data_dir)
        mean, std = MEAN_STD["eurosat"]
        num_classes = 10
    elif name in ("tissuemnist", "medmnist"):
        # the eval split is val (the USB convention)
        (data, targets), (tdata, ttargets), _ = load_medmnist(
            cfg.data_dir, "tissuemnist")
        mean, std = MEAN_STD["tissuemnist"]
        num_classes = cfg.num_classes
    elif name == "synthetic_orbit":
        if cfg.lb_imb_ratio != 1.0 or cfg.ulb_imb_ratio != 1.0:
            raise ValueError(
                "synthetic_orbit generates balanced splits directly and does "
                "not support lb/ulb_imb_ratio: use dataset='synthetic' for "
                "the imbalanced tier (validation.imb_gain does)")
        (lb_x, lb_y), (ulb_x, ulb_y), (ev_x, ev_y) = make_synthetic_orbit(
            cfg.num_classes, cfg.img_size, n_lb=cfg.num_labels,
            n_ulb=int(cfg.extra.get("synthetic_train", 2048)),
            n_test=int(cfg.extra.get("synthetic_test", 512)),
            seed=cfg.seed,
            noise=int(cfg.extra.get("synthetic_noise", 40)),
            rot_lab=float(cfg.extra.get("orbit_rot_lab", 10.0)),
            rot_max=float(cfg.extra.get("orbit_rot_max", 90.0)),
            proto_scale=int(cfg.extra.get("synthetic_proto_scale", 4)) or 4)
        return SSLDataBundle(
            train_lb=ArrayDataset(lb_x, lb_y),
            train_ulb=ArrayDataset(ulb_x, ulb_y),
            eval=ArrayDataset(ev_x, ev_y), num_classes=cfg.num_classes,
            mean=MEAN["synthetic"], std=STD["synthetic"])
    elif name == "synthetic":
        n_train = int(cfg.extra.get("synthetic_train", 2048))
        n_test = int(cfg.extra.get("synthetic_test", 256))
        (data, targets), (tdata, ttargets) = make_synthetic(
            cfg.num_classes, cfg.img_size, n_train, n_test, seed=cfg.seed,
            noise=int(cfg.extra.get("synthetic_noise", 40)),
            class_sim=float(cfg.extra.get("synthetic_class_sim", 0.0)),
            proto_scale=int(cfg.extra.get("synthetic_proto_scale", 0)))
        mean, std = MEAN["synthetic"], STD["synthetic"]
        num_classes = cfg.num_classes
    else:
        raise KeyError(f"dataset '{name}' is not ported yet; available: "
                       f"{', '.join(CV_DATASETS)}")

    rng = np.random.RandomState(cfg.seed)
    dump_dir = os.path.join(cfg.data_dir, "data_statistics", name,
                            "labeled_idx")
    lb_data, lb_targets, ulb_data, ulb_targets = split_ssl_data(
        data, targets, num_classes, cfg.num_labels,
        ulb_num_labels=cfg.ulb_num_labels,
        lb_imbalance_ratio=cfg.lb_imb_ratio,
        ulb_imbalance_ratio=cfg.ulb_imb_ratio,
        include_lb_to_ulb=cfg.include_lb_to_ulb,
        rng=rng,
        dump_dir=dump_dir if name != "synthetic" else None,
        dump_tag=f"labels{cfg.num_labels}_{cfg.lb_imb_ratio}"
                 f"_ulb{cfg.ulb_num_labels}_{cfg.ulb_imb_ratio}"
                 f"_seed{cfg.seed}")
    if alg == "fullysupervised":
        lb_data, lb_targets = data, targets
    return SSLDataBundle(
        train_lb=ArrayDataset(lb_data, lb_targets),
        train_ulb=ArrayDataset(ulb_data, ulb_targets),
        eval=ArrayDataset(tdata, ttargets),
        num_classes=num_classes, mean=mean, std=std)
