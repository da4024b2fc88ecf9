"""The Trainer and the eval CLI of the port on a regression set, on the
JAX package's own end-to-end setting
(``tests/test_modalities.py::test_regression_end_to_end``: an AgeDB npz of
32 px images, WRN-28-2, PseudoLabel, ``num_classes`` 1), both packages'
Trainers run on it: float targets through the loader and the step, the
eval keys and the best checkpoint by -mse as JAX's Trainer gives them, the
metrics JAX's function of the predictions (1e-9); a resume restores the
best-model tracking; class-balanced sampling refuses float targets. The
eval CLI on a regression checkpoint prints the metrics and raises
``KeyError`` on ``top-1-acc`` in both packages (the JAX package's
behaviour, kept).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from semireward_tpu.core import metrics as jmetrics
from semireward_tpu_torch.config import get_config as torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _e2e_cfg(tmp_path, **kw):
    """The JAX package's test_regression_end_to_end setting."""
    return {**dict(algorithm="pseudolabel", dataset="agedb", num_classes=1,
                   num_labels=8, data_dir=str(tmp_path), img_size=32,
                   net="wrn_28_2", batch_size=8, uratio=1, num_train_iter=2,
                   num_eval_iter=2, num_log_iter=1, eval_batch_size=8,
                   compute_dtype="float32", save_dir=str(tmp_path),
                   save_name="reg"), **kw}


@pytest.fixture(scope="module")
def agedb_runs(tmp_path_factory):
    """Both Trainers on the JAX test's AgeDB npz (64 + 16 images at 32
    px), two steps, an eval at step 2 and a checkpoint."""
    import semireward_tpu as st
    from semireward_tpu_torch.core.trainer import Trainer

    root = tmp_path_factory.mktemp("agedb")
    rs = np.random.RandomState(0)
    os.makedirs(root / "agedb")
    np.savez(root / "agedb" / "agedb.npz",
             train_x=rs.randint(0, 255, (64, 32, 32, 3), np.uint8),
             train_y=rs.uniform(1, 90, 64).astype(np.float32),
             test_x=rs.randint(0, 255, (16, 32, 32, 3), np.uint8),
             test_y=rs.uniform(1, 90, 16).astype(np.float32))
    jcfg = st.get_config(_e2e_cfg(root / "jax", mesh_shape=(-1,)))
    jcfg.data_dir = str(root)
    jres = st.Trainer(jcfg).fit()
    tcfg = torch_config(**_e2e_cfg(root / "torch"))
    tcfg.data_dir = str(root)
    trainer = Trainer(tcfg, device="cpu")
    batches = []
    step = trainer._step
    trainer._step = lambda st_, b, g: batches.append(b) or step(st_, b, g)
    tres = trainer.train()
    return root, jres, tres, trainer, batches


def test_trainer_evaluates_regression_as_jax(agedb_runs):
    root, jres, tres, trainer, batches = agedb_runs
    assert trainer.cfg.is_regression  # derived from num_classes 1
    assert sorted(tres) == sorted(jres)
    for k in ("eval/mse", "eval/rmse", "eval/mae", "eval/mape", "eval/r2"):
        assert k in tres and np.isfinite(tres[k])
    assert "eval/top-1-acc" not in tres
    # the labels go through as float32, never cast to classes
    assert all(b["y_lb"].dtype == torch.float32 for b in batches)
    assert not float((batches[0]["y_lb"] - batches[0]["y_lb"].round())
                     .abs().max()) == 0.0
    # best by -mse, in the checkpoint too
    assert trainer.best_metric == tres["eval/best_acc"] == -tres["eval/mse"]
    best = os.path.join(str(root / "torch"), "reg", "model_best.ckpt")
    assert os.path.exists(best)
    # the eval metrics are JAX's function of the predictions
    m = trainer.evaluate()
    logits = np.concatenate([trainer._logits(b["x"])[b["mask"]][:, 0]
                             for b in trainer._eval_batches(
                                 trainer.bundle.eval)])
    want = jmetrics.regression_metrics(trainer.bundle.eval.targets, logits)
    assert m.keys() == want.keys()
    for k in want:
        assert abs(m[k] - want[k]) <= 1e-9 * max(1.0, abs(want[k])), k


def test_regression_run_resumes(agedb_runs):
    from semireward_tpu_torch.core.trainer import Trainer

    root, _, tres, trainer, _ = agedb_runs
    cfg = torch_config(**_e2e_cfg(root / "torch", num_train_iter=3,
                                  num_eval_iter=3))
    cfg.data_dir = str(root)
    again = Trainer(cfg, device="cpu")
    extra = again.load(os.path.join(str(root / "torch"), "reg",
                                    "latest_model.ckpt"))
    assert extra["it"] == 2 and again.state.step == 2
    assert again.best_metric == trainer.best_metric
    res = again.train()
    assert again.state.step == 3 and np.isfinite(res["eval/mse"])
    assert again.best_metric == max(trainer.best_metric, -res["eval/mse"])


def test_class_balanced_sampling_refuses_float_targets(agedb_runs):
    from semireward_tpu_torch.data.loader import SSLLoader

    trainer = agedb_runs[3]
    with pytest.raises(ValueError, match="regression"):
        SSLLoader(trainer.bundle, 8, 8, sampler="WeightedRandomSampler")


def _load_cli(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_cli_raises_key_error_on_a_regression_checkpoint_in_both(
        agedb_runs, capsys):
    """Both CLIs print the regression metrics, then look up ``top-1-acc``
    and raise ``KeyError`` (the JAX package's behaviour, kept)."""
    from semireward_tpu_torch import eval as tev

    root = str(agedb_runs[0])
    args = ["--dataset", "agedb", "--data_dir", root, "--net", "wrn_28_2",
            "--num_classes", "1", "--img_size", "32", "--batch_size", "8"]
    jev = _load_cli(os.path.join(REPO, "eval.py"), "jax_eval_cli")
    with pytest.raises(KeyError, match="top-1-acc"):
        jev.main(["--load_path", _jax_best(root)] + args)
    jax_out = capsys.readouterr().out
    with pytest.raises(KeyError, match="top-1-acc"):
        tev.main(["--load_path", os.path.join(root, "torch", "reg",
                                              "model_best.ckpt"),
                  "--device", "cpu"] + args)
    torch_out = capsys.readouterr().out
    for out in (jax_out, torch_out):
        assert [line.split(":")[0] for line in out.splitlines()] == [
            "mae", "mape", "mse", "r2", "rmse"]


def _jax_best(root):
    run = os.path.join(root, "jax", "reg")
    best = [f for f in os.listdir(run) if f.startswith("model_best")]
    assert best, os.listdir(run)
    return os.path.join(run, best[0])
