"""The port imports with no JAX, Flax, optax or JAX-package module loaded."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import sys
import semireward_tpu_torch
import semireward_tpu_torch.train
import semireward_tpu_torch.convert
import semireward_tpu_torch.core.trainer
import semireward_tpu_torch.core.checkpoint
import semireward_tpu_torch.utils.metrics_sink
import semireward_tpu_torch.models.utils
import semireward_tpu_torch.eval
import semireward_tpu_torch.data.audio
import semireward_tpu_torch.profile_step
import semireward_tpu_torch.ab_flash
import semireward_tpu_torch.models.wrappers
import semireward_tpu_torch.algorithms.pimodel
import semireward_tpu_torch.algorithms.vat
import semireward_tpu_torch.algorithms.mixmatch
import semireward_tpu_torch.algorithms.remixmatch
import semireward_tpu_torch.algorithms.uda
import semireward_tpu_torch.algorithms.dash
import semireward_tpu_torch.algorithms.adamatch
import semireward_tpu_torch.algorithms.crmatch
import semireward_tpu_torch.algorithms.comatch
import semireward_tpu_torch.algorithms.simmatch
import semireward_tpu_torch.imb
import semireward_tpu_torch.imb.base
import semireward_tpu_torch.imb.saw
import semireward_tpu_torch.imb.debiaspl
import semireward_tpu_torch.imb.adsh
import semireward_tpu_torch.imb.abc
import semireward_tpu_torch.imb.tras
import semireward_tpu_torch.imb.darp
import semireward_tpu_torch.imb.daso
import semireward_tpu_torch.imb.crest
import semireward_tpu_torch.imb.cossl
import semireward_tpu_torch.models.resnet
import semireward_tpu_torch.validation
import semireward_tpu_torch.golden_quality
import semireward_tpu_torch.draw_witness
import semireward_tpu_torch.data.bio
import semireward_tpu_torch.models.huggingface
import semireward_tpu_torch.models.dinov2
import semireward_tpu_torch.models.vit
import semireward_tpu_torch.algorithms.pseudolabel
import semireward_tpu_torch.algorithms.semireward
import semireward_tpu_torch.core.losses
import semireward_tpu_torch.data.cv_extra
import semireward_tpu_torch.data.datasets
import semireward_tpu_torch.data.loader
import semireward_tpu_torch.parallel
import semireward_tpu_torch.parallel.mesh
import semireward_tpu_torch.data.modality
import semireward_tpu_torch.ops.attention
import semireward_tpu_torch.ops.fused_mlp
import semireward_tpu_torch.models.bert
import semireward_tpu_torch.models.hubert
import semireward_tpu_torch.models.batchnorm
import semireward_tpu_torch.core.step
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'semireward_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_device(monkeypatch):
    """With no card and no device='cpu', entry points raise; they never drop
    to the CPU on their own."""
    import pytest
    import torch

    from semireward_tpu_torch import resolve_device

    from semireward_tpu_torch import eval as port_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.main(["--load_path", "absent.ckpt", "--dataset",
                        "synthetic"])
