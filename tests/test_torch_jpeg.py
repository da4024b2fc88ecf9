"""The JPEG-folder datasets of the port (``imagenet``, ``imagenet127``,
``food101``, ``semi_aves``) held against the JAX package on a small seeded
folder (3 classes, 24 train and 6 val images of 200-500 px, and ImageNet's
three awkward files: a grayscale JPEG, a CMYK JPEG and a PNG under a
``.JPEG`` name), both sides on PIL (``SRT_DISABLE_NATIVE_JPEG`` on the JAX
side, ``device="cpu"`` on the port's):

- each dataset's paths, labels, labeled / unlabeled indices, dumped index
  files and gathered batches bit-equal;
- the full-size views with JAX's draws injected: the weak view's crop of
  the larger decode bit-equal, RandomResizedCrop's boxes bit-equal on the
  same uniforms and its bilinear crop (with the flip) within 1e-3 on the
  0-255 scale;
- the eval center crop and ``AugmentSpec.src_size`` as JAX's trainer sets
  them; the imb hooks' whole-split forward uncropped, as in JAX;
- three SRFlexMatch steps of a narrow ViT on views of the folder's
  batches against JAX's (``test_torch_step.run_three_sr_steps``);
- JAX's CoSSL warm start and CReST's ``train_crest`` fail on a JPEG set
  (they read ``.data``), and the port's raise ``NotImplementedError``
  there;
- the card route's resize on the CPU within one level of PIL's on the same
  pixels; the seeded writer; the build's per-source link flags.
The card route itself (nvJPEG) is held against the CPU route in
``tests/test_torch_kernels_cuda.py``.
"""
import glob
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semireward_tpu.config import get_config as jax_config
from semireward_tpu.data import datasets as JD
from semireward_tpu.data.augment import pipeline as jpipe
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.data import cv_extra as TX
from semireward_tpu_torch.data import datasets as TD
from semireward_tpu_torch.data.augment import pipeline as tpipe

CLASSES, N_TRAIN, N_VAL = 3, 24, 6
PLANTED = ("planted_cmyk.JPEG", "planted_gray.JPEG", "planted_png.JPEG")
MEAN, STD = TX.MEAN_STD["imagenet"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """The seeded ImageNet-layout folder, and the same images as a
    food101 (train / test lists) and a semi_aves (labeled / unlabeled / val
    lists, under their second-choice names where one exists) corpus."""
    root = str(tmp_path_factory.mktemp("jpeg"))
    TD.write_synthetic_jpeg_folder(root, CLASSES, N_TRAIN, N_VAL, seed=3)
    train = sorted(glob.glob(os.path.join(root, "imagenet/train/*/*.JPEG")))
    val = sorted(glob.glob(os.path.join(root, "imagenet/val/*/*.JPEG")))
    label = lambda p: int(os.path.basename(os.path.dirname(p))[1:])
    for name in ("food101", "semi_aves"):
        shutil.copytree(os.path.join(root, "imagenet"),
                        os.path.join(root, name, "images"))

    def write(name, fname, paths, labels=None):
        with open(os.path.join(root, name, fname), "w") as f:
            for i, p in enumerate(paths):
                rel = os.path.join("images", os.path.relpath(
                    p, os.path.join(root, "imagenet")))
                y = label(p) if labels is None else labels
                f.write(f"{rel} {y}\n")

    write("food101", "train_list.txt", train)
    write("food101", "test_list.txt", val)
    write("semi_aves", "l_train.txt", train[:9])
    write("semi_aves", "u_train_in.txt", train[9:], -1)
    write("semi_aves", "test.txt", val)
    return root


def _cfgs(name, root, **kw):
    d = dict(dict(dataset=name, data_dir=root, num_classes=CLASSES,
                  num_labels=6, img_size=56, algorithm="fixmatch", seed=1),
             **kw)
    return jax_config(**d), torch_config(**d)


DATASETS = {"imagenet": {}, "food101": {}, "semi_aves": {},
            "imagenet127": dict(num_labels=4, lb_imb_ratio=2.0,
                                ulb_num_labels=4, ulb_imb_ratio=2.0)}


def _dumps(root, name):
    return {os.path.basename(p): np.load(p) for p in sorted(glob.glob(
        os.path.join(root, "data_statistics", name, "labeled_idx",
                     "*.npy")))}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_and_batches_equal_jax(folder, name, monkeypatch):
    monkeypatch.setenv("SRT_DISABLE_NATIVE_JPEG", "1")
    jcfg, tcfg = _cfgs(name, folder, **DATASETS[name])
    shutil.rmtree(os.path.join(folder, "data_statistics"), ignore_errors=True)
    jb = JD.get_dataset(jcfg, "fixmatch")
    jdump = _dumps(folder, name)
    shutil.rmtree(os.path.join(folder, "data_statistics"), ignore_errors=True)
    tb = TD.get_dataset(tcfg, "fixmatch", device="cpu")
    assert _dumps(folder, name).keys() == jdump.keys()
    for k, v in _dumps(folder, name).items():
        np.testing.assert_array_equal(v, jdump[k])
    assert (name == "semi_aves") == (not jdump)
    assert (tb.mean, tb.std, tb.num_classes) == (jb.mean, jb.std,
                                                 jb.num_classes)
    for split in ("train_lb", "train_ulb", "eval"):
        j, t = getattr(jb, split), getattr(tb, split)
        assert t.paths == j.paths and t.img_size == j.img_size == 64
        np.testing.assert_array_equal(t.targets, j.targets)
        idx = np.arange(len(t))
        np.testing.assert_array_equal(t.gather(idx), j.gather(idx))
    if name == "imagenet":
        names = {os.path.basename(p) for p in tb.train_ulb.paths}
        assert set(PLANTED) <= names  # the awkward files are gathered too
    if name == "imagenet127":
        counts = np.bincount(tb.train_lb.targets, minlength=CLASSES)
        assert counts[0] > counts[-1]  # the imbalanced split


def _rrc_draws(k1, B):
    """The draws of JAX's random_resized_crop from ``k1``, as it draws."""
    k1, k2, k3, k4 = jax.random.split(k1, 4)
    area = jax.random.uniform(k1, (B,), minval=0.08, maxval=1.0)
    lr = jax.random.uniform(k2, (B,), minval=jnp.log(3 / 4),
                            maxval=jnp.log(4 / 3))
    return [np.asarray(a) for a in (area, lr, jax.random.uniform(k3, (B,)),
                                    jax.random.uniform(k4, (B,)))]


def _images(B=6, S=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, S, S, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("seed", [0, 5])
def test_random_resized_crop_and_flip_match_jax(seed):
    x = _images(seed=seed)
    B, H, W = x.shape[:3]
    rng = jax.random.PRNGKey(seed)
    k1, kf, _ = jax.random.split(rng, 3)
    want = np.asarray(jpipe._hflip_batch(kf, jpipe.random_resized_crop(
        k1, jnp.asarray(x, jnp.float32), 56)))
    area, lr, ux, uy = _rrc_draws(k1, B)
    flip = np.asarray(jax.random.bernoulli(kf, 0.5, (B,)))
    d = tpipe.ResizedCropDraws(*(torch.from_numpy(a) for a in
                                 (area, lr, ux, uy, flip)))
    # the boxes, bit for bit: JAX's arithmetic on the same uniforms
    a = H * W * jnp.asarray(area)
    ar = jnp.exp(jnp.asarray(lr))
    w = jnp.clip(jnp.sqrt(a * ar).astype(jnp.int32), 1, W)
    h = jnp.clip(jnp.sqrt(a / ar).astype(jnp.int32), 1, H)
    x0 = (jnp.asarray(ux) * (W - w + 1)).astype(jnp.int32)
    y0 = (jnp.asarray(uy) * (H - h + 1)).astype(jnp.int32)
    got_box = tpipe.resized_crop_boxes(H, W, d)
    for g, j in zip(got_box, (x0, y0, w, h)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    got = tpipe.random_resized_crop(torch.from_numpy(x).float(), 56, d)
    assert got.shape == want.shape == (B, 56, 56, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_an_upsampling_box_extrapolates_and_equalize_takes_it_as_jax():
    """A box smaller than the output at the image's top-left corner puts
    JAX's bilinear sample points above and left of pixel 0: the first rows
    and columns extrapolate past [0, 255]. The port's crop does the same,
    and its ``equalize`` takes those values as JAX's one-hot form does (no
    bin, output 0), bit for bit; the whole strong view stays finite."""
    from semireward_tpu.data.augment import ops as jops
    from semireward_tpu_torch.data.augment import ops as tops

    x = np.zeros((2, 64, 64, 3), np.uint8)
    x[:, 1::2] = 255  # stripes: the extrapolation leaves [0, 255]
    B = len(x)
    d = tpipe.ResizedCropDraws(
        area=torch.full((B,), 0.08), log_ratio=torch.zeros(B),
        ux=torch.zeros(B), uy=torch.zeros(B), flip=torch.zeros(B, dtype=bool))
    got = tpipe.random_resized_crop(torch.from_numpy(x).float(), 56, d)
    assert float(got.min()) < 0.0 or float(got.max()) > 255.0
    want = np.asarray(jax.vmap(jops.equalize)(jnp.asarray(got.numpy()),
                                              jnp.zeros(B)))
    np.testing.assert_array_equal(
        tops.equalize(got, torch.zeros(B)).numpy(), want)
    spec = tpipe.AugmentSpec(56, 7, MEAN, STD, src_size=64)
    dr = tpipe.RandAugDraws(
        op_idx=torch.full((3, B), 4), u=torch.zeros(3, B),  # equalize x3
        cut_v=torch.zeros(B), cut_x=torch.zeros(B), cut_y=torch.zeros(B))
    view = tpipe.strong_augment(torch.from_numpy(x), spec, d, dr)
    assert view.shape == (B, 56, 56, 3) and torch.isfinite(view).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_weak_view_from_the_larger_decode_is_bit_exact(seed):
    """JAX's weak view of a full-size set (``_crop_from_larger`` through
    its one-hot crop on uint8, then normalize) against the port's gather
    on JAX's offsets and flips."""
    x = _images(seed=seed)
    B = x.shape[0]
    kw = dict(crop_size=56, crop_pad=7, mean=MEAN, std=STD, src_size=64)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jpipe.weak_augment(rng, jnp.asarray(x),
                                         jpipe.AugmentSpec(**kw)))
    keys = jax.vmap(lambda k: jax.random.split(k, 3))(jax.random.split(rng,
                                                                       B))
    draw = lambda i, f: np.asarray(jax.vmap(f)(keys[:, i]))
    oy = draw(1, lambda k: jax.random.randint(k, (), 0, 64 - 56 + 1))
    ox = draw(0, lambda k: jax.random.randint(k, (), 0, 64 - 56 + 1))
    flip = draw(2, lambda k: jax.random.bernoulli(k, 0.5))
    spec = tpipe.AugmentSpec(**kw)
    assert spec.full_size
    d = tpipe.CropDraws(torch.from_numpy(oy).long(),
                        torch.from_numpy(ox).long(), torch.from_numpy(flip))
    got = tpipe.weak_augment(torch.from_numpy(x), spec, d)
    np.testing.assert_array_equal(got.numpy(), want)
    crop = tpipe.crop_from_larger(torch.from_numpy(x), 56, d)
    for b in range(B):
        ref = x[b, oy[b]:oy[b] + 56, ox[b]:ox[b] + 56]
        np.testing.assert_array_equal(crop[b].numpy(),
                                      ref[:, ::-1] if flip[b] else ref)


def test_full_size_views_and_draw_ranges():
    spec = tpipe.AugmentSpec(56, 7, MEAN, STD, src_size=64)
    g = torch.Generator().manual_seed(0)
    dc = tpipe.draw_crop(4000, spec, g, "cpu")
    assert int(dc.oy.min()) == 0 and int(dc.oy.max()) == 8
    dr = tpipe.draw_strong_crop(4000, spec, g, "cpu")
    assert isinstance(dr, tpipe.ResizedCropDraws)
    assert 0.08 <= float(dr.area.min()) and float(dr.area.max()) < 1.0
    assert np.log(3 / 4) <= float(dr.log_ratio.min())
    assert float(dr.log_ratio.max()) < np.log(4 / 3)
    x = torch.from_numpy(_images())
    views = tpipe.augment_views(x, x, spec, ("x_lb", "x_ulb_w", "x_ulb_s"),
                                g)
    for v in views.values():
        assert v.shape == (6, 56, 56, 3) and torch.isfinite(v).all()
    # not full size: the reflect-pad path and its draws, as before
    small = tpipe.AugmentSpec(56, 7, MEAN, STD, src_size=56)
    assert not small.full_size
    assert isinstance(tpipe.draw_strong_crop(4, small, g, "cpu"),
                      tpipe.CropDraws)


def _trainer_cfgs(root, **kw):
    d = dict(dict(dataset="imagenet", data_dir=root, num_classes=CLASSES,
                  num_labels=6, img_size=56, algorithm="fixmatch",
                  net="wrn_28_2", batch_size=2, eval_batch_size=4,
                  num_train_iter=2, num_eval_iter=2, use_pretrain=False,
                  resume=False,
                  net_kwargs={"depth": 10, "widen_factor": 1}), **kw)
    return jax_config(**d), torch_config(**d)


def test_eval_center_crop_and_src_size_equal_jax_trainer(folder, tmp_path,
                                                         monkeypatch):
    from semireward_tpu.core.trainer import Trainer as JTrainer
    from semireward_tpu_torch.core.trainer import Trainer as TTrainer

    monkeypatch.setenv("SRT_DISABLE_NATIVE_JPEG", "1")
    jcfg, tcfg = _trainer_cfgs(folder, save_dir=str(tmp_path))
    jt = JTrainer(jcfg, use_mesh=False)
    tt = TTrainer(tcfg, device="cpu")
    assert tt.aug_spec.src_size == jt.aug_spec.src_size == 64
    assert tuple(tt.aug_spec) == tuple(jt.aug_spec)
    jbatches = list(jt._eval_batches(jt.bundle.eval))
    tbatches = list(tt._eval_batches(tt.bundle.eval))
    assert len(tbatches) == len(jbatches) == 2
    for j, t in zip(jbatches, tbatches):
        assert t["x"].shape == (4, 56, 56, 3)
        for k in ("x", "y", "mask"):
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
    # a decode one pixel wider than img_size still crops to it
    tt.cfg.img_size = 63
    assert next(tt._eval_batches(tt.bundle.eval))["x"].shape[1:3] == (63, 63)


def test_eval_cli_scores_an_imagenet_checkpoint_through_the_crop(
        folder, tmp_path):
    """Two steps of WRN-28-2 on the folder (decoded at 36 px for 32), then
    the eval CLI on the best checkpoint with ``--crop_ratio``: the same
    center crop, so the trainer's best eval top-1."""
    from semireward_tpu_torch import eval as port_eval
    from semireward_tpu_torch.core.trainer import Trainer

    _, cfg = _trainer_cfgs(folder, save_dir=str(tmp_path), img_size=32,
                           net_kwargs={}, num_log_iter=1)
    tr = Trainer(cfg, device="cpu")
    assert tr.aug_spec.src_size == 36
    results = tr.train()
    best = os.path.join(str(tmp_path), cfg.save_name, "model_best.ckpt")
    m = port_eval.main(["--load_path", best, "--dataset", "imagenet",
                        "--data_dir", folder, "--net", "wrn_28_2",
                        "--num_classes", str(CLASSES), "--img_size", "32",
                        "--crop_ratio", str(cfg.crop_ratio), "--batch_size",
                        str(cfg.eval_batch_size), "--device", "cpu"])
    assert m["top-1-acc"] == results["eval/best_acc"]


def test_imb_whole_split_forward_reads_the_decode_uncropped(folder,
                                                            monkeypatch):
    """SAW's and ADSH's unlabeled forward (``predict_ulb_logits``) takes
    the whole split through ``gather`` at the decode size, as JAX's."""
    from semireward_tpu.imb import base as jbase
    from semireward_tpu_torch.imb import base as tbase

    monkeypatch.setenv("SRT_DISABLE_NATIVE_JPEG", "1")
    jcfg, tcfg = _cfgs("imagenet", folder, eval_batch_size=8)
    seen = {"jax": [], "port": []}

    class Fake:
        def __init__(self, cfg, bundle, key):
            self.cfg, self.bundle, self.key = cfg, bundle, key
            self.model = torch.nn.Linear(1, 1)
            self.state = type("S", (), {"ema": [p.detach() for p in
                                                self.model.parameters()]})

        def _jit_eval(self, state, x):
            seen[self.key].append(np.asarray(x))
            return np.zeros((len(x), CLASSES), np.float32)

        def _logits(self, x, weights=None, out_key="logits"):
            seen[self.key].append(np.asarray(x))
            return np.zeros((len(x), CLASSES), np.float32)

    shutil.rmtree(os.path.join(folder, "data_statistics"), ignore_errors=True)
    jout = jbase.predict_ulb_logits(Fake(jcfg, JD.get_dataset(jcfg), "jax"))
    tout = tbase.predict_ulb_logits(Fake(
        tcfg, TD.get_dataset(tcfg, device="cpu"), "port"))
    assert jout.shape == tout.shape == (N_TRAIN + len(PLANTED), CLASSES)
    assert len(seen["jax"]) == len(seen["port"]) == 4
    for j, t in zip(seen["jax"], seen["port"]):
        assert t.shape == (8, 64, 64, 3)
        np.testing.assert_array_equal(t, j)


def test_three_srflexmatch_steps_on_the_folder_match_jax(folder):
    """The step of the slice on views of the folder's images: the port
    gathers a labeled and an unlabeled batch (decoded at 18 px for the
    narrow ViT's 16) and builds the weak and strong views of the
    full-size path; both packages' steps take those views."""
    from test_torch_step import B, S, run_three_sr_steps

    _, tcfg = _cfgs("imagenet", folder, img_size=S, num_labels=6)
    bundle = TD.get_dataset(tcfg, device="cpu")
    spec = tpipe.AugmentSpec(S, int(S * 0.125), MEAN, STD, src_size=18)
    g = torch.Generator().manual_seed(0)
    rs = np.random.RandomState(1)

    def views(step):
        lb = bundle.train_lb.gather(rs.randint(0, len(bundle.train_lb), B))
        ulb = bundle.train_ulb.gather(rs.randint(0, len(bundle.train_ulb),
                                                 B))
        assert lb.shape == (B, 18, 18, 3)
        return {k: v.numpy() for k, v in tpipe.augment_views(
            torch.from_numpy(lb), torch.from_numpy(ulb), spec,
            ("x_lb", "x_ulb_w", "x_ulb_s"), g).items()}

    def check(step, tstate, jstate, tm, jm):
        assert float(tm["util_ratio"]) == float(jm["util_ratio"]), step
        np.testing.assert_array_equal(tstate.algo.selected_label.numpy(),
                                      np.asarray(jstate.algo.selected_label))

    run_three_sr_steps("srflexmatch", check, views=views)


def test_cossl_and_crest_fail_on_a_jpeg_set_as_in_jax(folder, tmp_path,
                                                      monkeypatch):
    """JAX's CoSSL warm start and CReST's ``train_crest`` read ``.data``,
    which a JPEG set lacks: both raise ``AttributeError``. The port
    refuses them there by name; before its warm epoch CoSSL trains as the
    JAX one does."""
    from semireward_tpu.imb import cossl as jcossl
    from semireward_tpu.imb import crest as jcrest
    from semireward_tpu_torch.imb import cossl as tcossl
    from semireward_tpu_torch.imb import crest as tcrest

    monkeypatch.setenv("SRT_DISABLE_NATIVE_JPEG", "1")
    extra = dict(imb_algorithm="cossl", epoch=3, num_train_iter=6,
                 cossl_warm_epoch=2)
    jcfg, tcfg = _trainer_cfgs(folder, save_dir=str(tmp_path), **extra)
    jb, tb = JD.get_dataset(jcfg), TD.get_dataset(tcfg, device="cpu")
    info = {"lb_dest_len": len(tb.train_lb), "ulb_dest_len":
            len(tb.train_ulb), "lb_class_dist": np.full(CLASSES, 1 / 3)}
    from semireward_tpu.registry import ALGORITHMS as JALGS
    from semireward_tpu_torch.registry import ALGORITHMS as TALGS

    jalg = jcossl.CoSSL(jcfg, info, base_cls=JALGS.get("fixmatch"))
    talg = tcossl.CoSSL(tcfg, info, torch.device("cpu"),
                        base_cls=TALGS.get("fixmatch"))
    log = logging.getLogger("test_torch_jpeg")
    step = lambda n: type("State", (), {"step": n, "ema_params": {},
                                        "batch_stats": {}})()
    jtr = type("T", (), {"cfg": jcfg, "bundle": jb, "logger": log,
                         "aug_spec": None, "model": None})()
    ttr = type("T", (), {"cfg": tcfg, "bundle": tb, "logger": log})()
    # epoch 1 begins: no warm start on either side
    assert jalg.on_epoch_end(jtr, step(2)).step == 2
    assert talg.on_epoch_end(ttr, step(2)).step == 2
    with pytest.raises(AttributeError, match="data"):
        jalg.on_epoch_end(jtr, step(4))
    with pytest.raises(NotImplementedError, match="CoSSL's teacher warm"):
        talg.on_epoch_end(ttr, step(4))
    ccfg = dict(imb_algorithm="crest+", crest_num_gens=2)
    jcfg, tcfg = _trainer_cfgs(folder, save_dir=str(tmp_path), **ccfg)
    with pytest.raises(AttributeError, match="data"):
        jcrest.train_crest(jcfg)
    with pytest.raises(NotImplementedError, match="CReST's generation loop"):
        tcrest.train_crest(tcfg, device="cpu")


def test_card_resize_is_within_one_level_of_pil(folder):
    """The card route's resize (``_nvjpeg.resize_square``: antialiased
    bilinear, rounded) on the CPU, on PIL's decoded pixels, against PIL's
    ``BILINEAR`` resize: down (to 256, 128, 64) and up (to 512)."""
    from PIL import Image
    from semireward_tpu_torch.data._nvjpeg import resize_square

    paths = sorted(glob.glob(os.path.join(folder, "imagenet/train/*/*")))
    worst, means = 0, []
    for p in paths[:8]:
        with Image.open(p) as im:
            rgb = np.array(im.convert("RGB"))
        for size in (512, 256, 128, 64):
            got = resize_square(torch.from_numpy(rgb), size).numpy()
            want = np.asarray(Image.fromarray(rgb).resize((size, size),
                                                          Image.BILINEAR))
            assert got.shape == want.shape and got.dtype == np.uint8
            diff = np.abs(got.astype(int) - want.astype(int))
            worst, means = max(worst, int(diff.max())), means + [diff.mean()]
    assert worst <= 1 and np.mean(means) < 0.3, (worst, np.mean(means))
    same = np.array(Image.open(paths[0]).convert("RGB"))[:64, :64]
    np.testing.assert_array_equal(
        resize_square(torch.from_numpy(same), 64).numpy(), same)


def test_the_seeded_folder(folder, tmp_path):
    from PIL import Image

    train = glob.glob(os.path.join(folder, "imagenet/train/*/*.JPEG"))
    assert len(train) == N_TRAIN + len(PLANTED)
    assert len(os.listdir(os.path.join(folder, "imagenet/train"))) == CLASSES
    kinds = {}
    for p in train:
        with Image.open(p) as im:
            kinds[os.path.basename(p)] = (im.format, im.mode)
            if "planted" not in p:
                w, h = im.size
                assert 200 <= min(w, h) and max(w, h) <= 500
                assert 3 / 4 - 0.01 <= w / h <= 4 / 3 + 0.01
    assert kinds["planted_gray.JPEG"] == ("JPEG", "L")
    assert kinds["planted_cmyk.JPEG"] == ("JPEG", "CMYK")
    assert kinds["planted_png.JPEG"] == ("PNG", "RGB")
    assert sum(v == ("JPEG", "RGB") for v in kinds.values()) == N_TRAIN
    # the same arguments give the same bytes; a finished corpus is kept
    again = str(tmp_path)
    TD.write_synthetic_jpeg_folder(again, CLASSES, N_TRAIN, N_VAL, seed=3)
    for p in train:
        q = os.path.join(again, os.path.relpath(p, folder))
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read(), p
    stamp = os.path.getmtime(train[0].replace(folder, again))
    TD.write_synthetic_jpeg_folder(again, CLASSES, N_TRAIN, N_VAL, seed=3)
    assert os.path.getmtime(train[0].replace(folder, again)) == stamp


def test_the_card_is_the_default_and_there_is_no_cpu_fallback(folder):
    """Without ``device`` a JPEG set decodes on the card, and on a host
    without one it raises: it never falls back to the CPU route."""
    from semireward_tpu_torch.data._nvjpeg import NvJpeg

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, tcfg = _cfgs("imagenet", folder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.get_dataset(tcfg)
    with pytest.raises(ValueError, match="CUDA device"):
        NvJpeg("cpu")


def test_build_links_nvjpeg_into_the_decoder_alone(monkeypatch):
    """The nvcc command lines ``build_all`` runs, read without running
    nvcc: ``jpeg_decode`` links nvJPEG with an rpath to the toolkit's
    ``lib64``, the kernels link nothing more; every flag is in the
    library's hashed name."""
    from semireward_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_nvcc", lambda: "/opt/cuda-x/bin/nvcc")
    cmd = _build.command("jpeg_decode", "/tmp/x.so")
    assert cmd[0] == "/opt/cuda-x/bin/nvcc"
    assert cmd[1:1 + len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert "-lnvjpeg" in cmd and "-rpath=/opt/cuda-x/lib64" in cmd
    assert cmd[-3:] == ["-o", "/tmp/x.so",
                        str(_build.CSRC / "jpeg_decode.cu")]
    assert "jpeg_decode" in _build.sources()
    for name in ("fused_mlp", "fused_mlp_blocked", "flash_attention"):
        k = _build.command(name, "/tmp/y.so")
        assert k[1:-3] == _build.NVCC_FLAGS, name
    before = _build._target("jpeg_decode")
    assert before.name.startswith("jpeg_decode-")
    monkeypatch.setitem(_build.LINK_FLAGS, "jpeg_decode",
                        ["-lnvjpeg", "-lnvjpeg_static"])
    assert _build._target("jpeg_decode") != before
    kernel = _build._target("fused_mlp")
    monkeypatch.setattr(_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    assert _build._target("fused_mlp") == kernel
