"""The SemiReward YAML corpus in the port: every config under
``config/SemiReward/`` resolves (its algorithm in ``ALGORITHMS`` and built,
its net in ``NETS``, its dataset read by the port's loaders; the ImageNet
ones pass ``refuse_unported`` (gradient checkpointing is ported) and reach
the JPEG-folder loader, which reads their local folder). Plus two-step CPU
runs of the CLI on a usb_nlp ``srpseudolabel`` and a usb_audio
``srsoftmatch`` YAML at the shrunk sizes of the slices' CLI tests: token
dicts and waveforms through PseudoLabel's separate forwards and SoftMatch's
weighting. And CoMatch's and SimMatch's YAMLs of every suite: each
resolves, and one per modality builds a CPU Trainer at full size."""
import glob
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from semireward_tpu_torch import config as config_lib
from semireward_tpu_torch.core.trainer import refuse_unported
from semireward_tpu_torch.data import datasets as TD
from semireward_tpu_torch.data.modality import modality_of
from semireward_tpu_torch.registry import ALGORITHMS, NETS

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "config", "SemiReward")
SUITES = {"classic_cv": 150, "usb_cv": 120, "usb_nlp": 150,
          "usb_audio": 135, "imagenet_stretch": 15}
DATA_INFO = {"ulb_dest_len": 64, "lb_dest_len": 16}


def _configs(suite):
    paths = sorted(glob.glob(os.path.join(ROOT, suite, "*", "*.yaml")))
    return [(p, config_lib.from_yaml(p)) for p in paths]


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_every_semireward_yaml_resolves(suite, tmp_path):
    configs = _configs(suite)
    assert len(configs) == SUITES[suite]
    for path, cfg in configs:
        NETS.get(cfg.net)
        alg = ALGORITHMS.get(cfg.algorithm)(cfg, DATA_INFO,
                                            torch.device("cpu"))
        assert alg.NAME == cfg.algorithm and alg.HAS_SR, path
        modality = modality_of(cfg.net)
        if suite == "imagenet_stretch":
            assert cfg.gradient_checkpointing, path
            refuse_unported(cfg)
            assert cfg.dataset in TD.JPEG_DATASETS, path
            cfg.data_dir = str(tmp_path)
            with pytest.raises(FileNotFoundError, match="imagenet.train"):
                TD.get_dataset(cfg, device="cpu")
        elif modality == "cv":
            assert cfg.dataset in TD.CV_DATASETS, path
        else:  # the layout loaders read any corpus of their modality
            assert modality == {"usb_nlp": "nlp", "usb_audio": "audio"}[suite]


def test_555_of_570_resolve():
    # all 570 since the JPEG-folder datasets: the 15 imagenet_stretch
    # YAMLs resolve too, on the JPEG-folder loader
    assert sum(SUITES.values()) == len(glob.glob(
        os.path.join(ROOT, "*", "*", "*.yaml"))) == 570
    assert sum(SUITES.values()) - SUITES["imagenet_stretch"] == 555
    assert all(c.dataset in TD.JPEG_DATASETS
               for _, c in _configs("imagenet_stretch"))


def test_cli_trains_a_usb_nlp_srpseudolabel_yaml_on_cpu(tmp_path,
                                                          monkeypatch):
    from semireward_tpu_torch import train as cli
    from semireward_tpu_torch.data.nlp import write_synthetic_corpus

    monkeypatch.setitem(sys.modules, "transformers", None)
    write_synthetic_corpus(str(tmp_path / "data"), "aclImdb", 2,
                           sizes=(("train", 24), ("dev", 10), ("test", 4)))
    argv = ["--c", os.path.join(ROOT, "usb_nlp", "pseudolabel",
                                "pseudolabel_aclImdb_100_0.yaml"),
            "--device", "cpu", "--use_pretrain", "False", "--resume",
            "False", "--data_dir", str(tmp_path / "data"), "--num_labels",
            "8", "--num_train_iter", "2", "--num_log_iter", "1",
            "--start_timing", "0", "--N_k", "1", "--max_length", "64",
            "--use_flash_attention", "True", "--use_fused_mlp", "False",
            "--feature_dim", "64", "--save_dir", str(tmp_path / "out"),
            "--net_kwargs", json.dumps(dict(hidden=64, layers=2, heads=2,
                                            intermediate=128))]
    results = cli.main(argv)
    assert all(math.isfinite(v) for v in results.values())
    assert 0.0 <= results["eval/top-1-acc"] <= 1.0


def test_cli_trains_a_usb_audio_srsoftmatch_yaml_on_cpu(tmp_path):
    from semireward_tpu_torch import train as cli
    from semireward_tpu_torch.data.audio import write_synthetic_corpus

    write_synthetic_corpus(str(tmp_path / "data"), "esc50", num_classes=5,
                           sizes=(("train", 30), ("dev", 6), ("test", 2)))
    argv = ["--c", os.path.join(ROOT, "usb_audio", "softmatch",
                                "softmatch_esc50_250_0.yaml"),
            "--device", "cpu", "--use_pretrain", "False", "--resume",
            "False", "--data_dir", str(tmp_path / "data"), "--num_classes",
            "5", "--num_labels", "10", "--num_train_iter", "2",
            "--num_log_iter", "1", "--start_timing", "0", "--N_k", "1",
            "--max_length_seconds", "0.1", "--eval_batch_size", "4",
            "--feature_dim", "64", "--save_dir", str(tmp_path / "out"),
            "--net_kwargs", json.dumps(dict(hidden=64, layers=2, heads=2))]
    results = cli.main(argv)
    assert all(math.isfinite(v) for v in results.values())
    assert 0.0 <= results["eval/top-1-acc"] <= 1.0
    assert np.isfinite(results["eval/best_acc"])


# ---------------------------------------------------------------------------
# the USB base algorithms' YAMLs (config/usb_cv, config/classic_cv)
# ---------------------------------------------------------------------------

USB_ROOT = os.path.dirname(ROOT)
USB_ALGOS = ("pimodel", "meanteacher", "vat", "mixmatch", "remixmatch", "uda",
             "dash", "adamatch", "crmatch", "defixmatch")
WRAPPED = {"remixmatch": "RotNet", "crmatch": "CRMatchNet"}


def _usb_configs(suite, algo):
    paths = sorted(glob.glob(os.path.join(USB_ROOT, suite, algo, "*.yaml")))
    return [(p, config_lib.from_yaml(p)) for p in paths]


@pytest.mark.parametrize("suite", ["usb_cv", "classic_cv"])
def test_every_usb_base_algorithm_yaml_resolves(suite):
    n = 0
    for algo in USB_ALGOS:
        configs = _usb_configs(suite, algo)
        assert len(configs) == {"usb_cv": 24, "classic_cv": 30}[suite], algo
        for path, cfg in configs:
            NETS.get(cfg.net)
            alg = ALGORITHMS.get(cfg.algorithm)(cfg, DATA_INFO,
                                                torch.device("cpu"))
            assert alg.NAME == cfg.algorithm == algo, path
            assert not getattr(alg, "HAS_SR", False), path
            assert cfg.dataset in TD.CV_DATASETS, path
            n += 1
    assert n == {"usb_cv": 240, "classic_cv": 300}[suite]


@pytest.mark.parametrize("algo", USB_ALGOS)
def test_usb_cv_yaml_builds_a_trainer_and_the_wrn_its_net(algo, tmp_path):
    from semireward_tpu_torch.core.trainer import Trainer

    path = os.path.join(USB_ROOT, "usb_cv", algo, f"{algo}_cifar100_200_0.yaml")
    cfg = config_lib.from_yaml(path, {
        "dataset": "synthetic", "use_pretrain": False, "resume": False,
        "synthetic_train": 400, "synthetic_test": 16,
        "save_dir": str(tmp_path)})
    tr = Trainer(cfg, device="cpu")
    assert type(tr.model).__name__ == WRAPPED.get(algo, "VisionTransformer")
    assert tr.model.num_features == 384
    assert len(tr.state.ema) == len(list(tr.model.parameters()))
    # the classic_cv WRN-28-2 under the algorithm's wrapper
    wcfg = config_lib.from_yaml(os.path.join(
        USB_ROOT, "classic_cv", algo, f"{algo}_cifar100_10000_0.yaml"))
    alg = ALGORITHMS.get(algo)(wcfg, DATA_INFO, torch.device("cpu"))
    net = alg.wrap_model(NETS.get(wcfg.net)(num_classes=wcfg.num_classes,
                                            dtype=torch.float32),
                         torch.Generator().manual_seed(0))
    out = net(torch.zeros(2, 32, 32, 3), train=False)
    assert out["logits"].shape == (2, 100)
    assert type(net).__name__ == WRAPPED.get(algo, "WideResNet")


# the text and audio MixMatch, ReMixMatch and VAT YAMLs as the JAX package
# takes them as written: the exception its loss raises at the first step
# (None: it trains), and the switches that make it train
AS_WRITTEN = {
    ("usb_nlp", "mixmatch"): (TypeError, {"mixup_manifold": True}),
    ("usb_nlp", "remixmatch"): (TypeError, {"mixup_manifold": True,
                                            "rot_loss_ratio": 0.0}),
    ("usb_nlp", "vat"): (AttributeError, {"vat_embed": True}),
    ("usb_audio", "mixmatch"): (None, {}),
    ("usb_audio", "remixmatch"): (KeyError, {"rot_loss_ratio": 0.0}),
    ("usb_audio", "vat"): (None, {})}


def _small_corpus(cfg, root):
    """A seeded corpus of the YAML's dataset and classes, two labels a
    class, and a small net of the YAML's family (building the Trainer is
    what is held here, not the net's size)."""
    from semireward_tpu_torch.data import audio, nlp

    name, nc = cfg.dataset, cfg.num_classes
    if modality_of(cfg.net) == "nlp":
        nlp.write_synthetic_corpus(str(root), name, nc, sizes=(
            ("train", 12 * nc), ("dev", 4), ("test", 2)))
        geom = dict(hidden=64, layers=1, heads=2, intermediate=128)
    else:
        audio.write_synthetic_corpus(str(root), name, nc, sample_rate=800,
                                     sizes=(("train", 4 * nc), ("dev", 4),
                                            ("test", 2)))
        geom = dict(hidden=64, layers=1, heads=2)
    return {"data_dir": str(root), "num_labels": 2 * nc, "net_kwargs": geom,
            "use_pretrain": False, "resume": False}


@pytest.mark.parametrize("suite,algo", sorted(AS_WRITTEN))
def test_what_this_slice_does_not_take_raises_naming_its_item(suite, algo,
                                                              tmp_path,
                                                              monkeypatch):
    """Every text and audio MixMatch, ReMixMatch and VAT YAML resolves; each
    that the JAX package trains as written builds a CPU Trainer; each that
    it fails on (tests/test_torch_text_audio_mixup_vat.py shows JAX fail)
    raises the JAX loss's exception type in the port, naming the switch or
    key, before any data is read, and builds a Trainer with the switches
    that make JAX train it. (The name is the slice's that refused them all,
    naming ROADMAP items 11 and 12.)"""
    from semireward_tpu_torch.core.trainer import Trainer

    monkeypatch.setitem(sys.modules, "transformers", None)
    exc, fix = AS_WRITTEN[suite, algo]
    configs = _usb_configs(suite, algo)
    assert len(configs) == {"usb_nlp": 30, "usb_audio": 27}[suite]
    for path, cfg in configs:
        NETS.get(cfg.net)
        assert modality_of(cfg.net) == {"usb_nlp": "nlp",
                                        "usb_audio": "audio"}[suite], path
        assert cfg.algorithm == algo and not (
            cfg.mixup_manifold or cfg.vat_embed), path
        over = _small_corpus(cfg, tmp_path / "data")
        over["save_dir"] = str(tmp_path / "out")
        if exc is not None:
            with pytest.raises(exc, match="|".join(fix)):
                refuse_unported(cfg)
            cfg = config_lib.from_yaml(path, {**over, **fix})
        else:
            cfg = config_lib.from_yaml(path, over)
        tr = Trainer(cfg, device="cpu")
        assert tr.alg.NAME == algo and len(tr.state.ema) == len(
            list(tr.model.parameters())), path
        assert type(tr.model).__name__ != "RotNet", path


# ---------------------------------------------------------------------------
# CoMatch and SimMatch
# ---------------------------------------------------------------------------

CO_SIM_YAMLS = {"usb_cv": 24, "classic_cv": 30, "usb_nlp": 30,
                "usb_audio": 27}
CO_SIM_NETS = {"comatch": "ProjectionNet", "simmatch": "SimMatchNet"}


@pytest.mark.parametrize("algo", sorted(CO_SIM_NETS))
@pytest.mark.parametrize("suite", sorted(CO_SIM_YAMLS))
def test_every_comatch_simmatch_yaml_resolves(suite, algo):
    configs = _usb_configs(suite, algo)
    assert len(configs) == CO_SIM_YAMLS[suite]
    for path, cfg in configs:
        NETS.get(cfg.net)
        alg = ALGORITHMS.get(cfg.algorithm)(cfg, DATA_INFO,
                                            torch.device("cpu"))
        assert type(alg).__name__ == {"comatch": "CoMatch",
                                      "simmatch": "SimMatch"}[algo], path
        assert alg.NAME == cfg.algorithm == algo, path
        modality = modality_of(cfg.net)
        assert modality == {"usb_nlp": "nlp", "usb_audio": "audio"}.get(
            suite, "cv"), path
        if modality == "cv":
            assert cfg.dataset in TD.CV_DATASETS, path


def _co_sim_trainer_config(algo, modality, root):
    """The algorithm's YAML of a modality at its full geometry on seeded
    data: usb_cv CIFAR-100 (synthetic images), usb_nlp aclImdb and
    usb_audio ESC-50 (small seeded corpora of their layouts)."""
    from semireward_tpu_torch.data import audio, nlp

    yaml, data_dir = {
        "cv": (f"usb_cv/{algo}/{algo}_cifar100_200_0.yaml", None),
        "nlp": (f"usb_nlp/{algo}/{algo}_aclImdb_100_0.yaml", "text"),
        "audio": (f"usb_audio/{algo}/{algo}_esc50_250_0.yaml", "audio")}[
            modality]
    over = {"use_pretrain": False, "resume": False,
            "save_dir": str(root / "out")}
    if modality == "cv":
        over.update(dataset="synthetic", synthetic_train=400,
                    synthetic_test=16)
    elif modality == "nlp":
        nlp.write_synthetic_corpus(str(root / data_dir), "aclImdb", 2,
                                   sizes=(("train", 24), ("dev", 4),
                                          ("test", 2)))
        over.update(data_dir=str(root / data_dir), num_labels=8)
    else:
        audio.write_synthetic_corpus(str(root / data_dir), "esc50",
                                     num_classes=5,
                                     sizes=(("train", 20), ("dev", 5),
                                            ("test", 1)))
        over.update(data_dir=str(root / data_dir), num_classes=5,
                    num_labels=10)
    return config_lib.from_yaml(os.path.join(USB_ROOT, yaml), over)


@pytest.mark.parametrize("modality", ["cv", "nlp", "audio"])
@pytest.mark.parametrize("algo", sorted(CO_SIM_NETS))
def test_comatch_simmatch_yaml_builds_a_trainer(algo, modality, tmp_path,
                                                monkeypatch):
    """Each algorithm's YAML of each modality builds a CPU Trainer with
    its wrapped net at full width and depth (ViT-S/2-32, BERT-base,
    HuBERT-base), whose forward gives the head's normalized features; the
    classic_cv YAML's WRN-28-2 under the wrapper too."""
    from semireward_tpu_torch.core.trainer import Trainer

    monkeypatch.setitem(sys.modules, "transformers", None)
    cfg = _co_sim_trainer_config(algo, modality, tmp_path)
    tr = Trainer(cfg, device="cpu")
    assert type(tr.model).__name__ == CO_SIM_NETS[algo]
    assert tr.model.num_features == {"cv": 384}.get(modality, 768)
    assert len(tr.state.ema) == len(list(tr.model.parameters()))
    assert tr.alg.BATCH_KEYS == ALGORITHMS.get(algo).BATCH_KEYS
    if algo == "simmatch":
        assert tr.state.algo.mem_bank.shape == (128, tr.bundle.lb_dest_len)
        assert not tr.alg.use_ema_teacher
    else:
        assert tr.state.algo.queue_feats.shape == (
            128 * (cfg.uratio + 1) * cfg.batch_size, 128)
    batch = tr.make_batch(next(tr._make_loader()), keys=("x_lb",))
    with torch.no_grad():
        out = tr.model(batch["x_lb"], train=False)
    assert out["feat"].shape == (cfg.batch_size, 128)
    assert torch.allclose(out["feat"].norm(dim=1),
                          torch.ones(cfg.batch_size), atol=1e-5)
    if modality == "cv":  # and the classic_cv WRN-28-2 under the wrapper
        wcfg = config_lib.from_yaml(os.path.join(
            USB_ROOT, "classic_cv", algo, f"{algo}_cifar100_10000_0.yaml"))
        alg = ALGORITHMS.get(algo)(wcfg, DATA_INFO, torch.device("cpu"))
        net = alg.wrap_model(NETS.get(wcfg.net)(num_classes=100,
                                                dtype=torch.float32),
                             torch.Generator().manual_seed(0))
        out = net(torch.zeros(2, 32, 32, 3), train=False)
        assert type(net).__name__ == CO_SIM_NETS[algo]
        assert out["logits"].shape == (2, 100) and out["feat"].shape == (
            2, 128)


# ---------------------------------------------------------------------------
# the imbalanced-SSL YAMLs (config/classic_cv_imb)
# ---------------------------------------------------------------------------

IMB_ROOT = os.path.join(USB_ROOT, "classic_cv_imb")
IMB_NAMES = ("abc", "adsh", "cossl", "crest", "crest+", "darp", "daso",
             "debiaspl", "saw", "tras")
IMB_HEAD = {"abc": ("AuxHeadNet", "logits_aux"),
            "tras": ("AuxHeadNet", "logits_aux"),
            "cossl": ("CoSSLNet", "logits_tfe")}
# YAMLs naming each wrapper on wrn_28_2 (CIFAR-10, CIFAR-100, STL-10)
IMB_WRN_YAMLS = {"abc": 66, "adsh": 33, "cossl": 66, "crest": 66,
                 "crest+": 66, "darp": 66, "daso": 66, "debiaspl": 66,
                 "saw": 66, "tras": 33}


def _imb_configs():
    return [(p, config_lib.from_yaml(p)) for p in sorted(
        glob.glob(os.path.join(IMB_ROOT, "*", "*.yaml")))]


@pytest.mark.parametrize("name", IMB_NAMES)
def test_every_imb_yaml_on_the_wrn_builds_its_wrapper(name):
    """Each classic_cv_imb YAML naming ``name`` on wrn_28_2: the trainer's
    refusals pass, the wrapper builds over its base, and the wrapped
    WRN-28-2 (one a base and class count) gives the head the wrapper
    evaluates."""
    from semireward_tpu_torch import imb
    from semireward_tpu_torch.core.trainer import refuse_unported

    nets, n = {}, 0
    for path, cfg in _imb_configs():
        if cfg.imb_algorithm != name or cfg.net != "wrn_28_2":
            continue
        refuse_unported(cfg)
        info = dict(DATA_INFO, lb_class_dist=np.linspace(
            1.0, 0.01, cfg.num_classes) / np.linspace(
            1.0, 0.01, cfg.num_classes).sum(), num_features=128)
        alg = imb.get_imb_algorithm(name)(cfg, info, torch.device("cpu"),
                                          base_cls=ALGORITHMS.get(
                                              cfg.algorithm))
        assert alg.base.NAME == cfg.algorithm, path
        assert cfg.dataset in TD.CV_DATASETS, path
        key = (cfg.algorithm, cfg.num_classes)
        if key not in nets:
            net = alg.wrap_model(NETS.get(cfg.net)(
                num_classes=cfg.num_classes, dtype=torch.float32),
                torch.Generator().manual_seed(0))
            with torch.no_grad():
                out = net(torch.zeros(2, 32, 32, 3), train=False)
            wrapper, head = IMB_HEAD.get(name, (
                "RotNet" if cfg.algorithm == "remixmatch" else "WideResNet",
                "logits"))
            assert type(net).__name__ == wrapper, path
            assert out[head].shape == (2, cfg.num_classes), path
            nets[key] = net
        n += 1
    assert n == IMB_WRN_YAMLS[name]


def test_imb_yaml_counts_and_the_resnet50_refusal(tmp_path):
    """594 of the 702 classic_cv_imb YAMLs that name a wrapper are on
    wrn_28_2; the other 108, and the 18 plain ones, run resnet50 on
    imagenet127: each passes ``refuse_unported`` (ResNet-50 is ported) and
    its Trainer reaches the JPEG-folder loader (the ImageNet data is
    ported too), which reads its local folder. The ABC one builds a CPU
    Trainer on synthetic data, at the split's ratio 286, and trains two
    steps."""
    from semireward_tpu_torch.core.trainer import Trainer

    configs = _imb_configs()
    named = [c for _, c in configs if c.imb_algorithm]
    assert len(configs) == 819 and len(named) == 702
    assert sum(c.net == "wrn_28_2" for c in named) == sum(
        IMB_WRN_YAMLS.values()) == 594
    resnet = [(p, c) for p, c in configs if c.net == "resnet50"]
    assert len(resnet) == 126
    assert all(c.dataset == "imagenet127" for _, c in resnet)
    for path, cfg in resnet:
        cfg.save_dir = cfg.data_dir = str(tmp_path)
        refuse_unported(cfg)
        with pytest.raises(FileNotFoundError, match="imagenet.train"):
            Trainer(cfg, device="cpu")
    path = next(p for p, c in resnet if c.imb_algorithm == "abc")
    cfg = config_lib.from_yaml(path, {
        "save_dir": str(tmp_path), "dataset": "synthetic", "img_size": 32,
        "num_labels": 286, "ulb_num_labels": 572, "batch_size": 4,
        "uratio": 1, "eval_batch_size": 16, "num_train_iter": 2,
        "num_eval_iter": 2, "num_log_iter": 1, "resume": False,
        "synthetic_train": 1270, "synthetic_test": 16})
    tr = Trainer(cfg, device="cpu")
    assert type(tr.model).__name__ == "AuxHeadNet"
    assert type(tr.model.backbone).__name__ == "ResNet50"
    assert len(tr.bundle.train_lb) < len(tr.bundle.train_ulb) + 286 * 127
    results = tr.train()
    assert tr.state.step == 2
    assert all(math.isfinite(v) for v in results.values()), results
