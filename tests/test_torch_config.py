"""Config parity: every config/SemiReward/usb_cv/flexmatch/*.yaml (the
headline one included) loads to the same Config fields through the JAX
package and the port, per-algorithm defaults merged. Exact equality: the
loaders are the same host code."""
import dataclasses
import glob
import os

import pytest

from semireward_tpu.config import from_yaml as jax_from_yaml
from semireward_tpu_torch.config import from_yaml as torch_from_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(
    ROOT, "config/SemiReward/usb_cv/flexmatch/*.yaml")))


def test_corpus_present():
    assert any(p.endswith("flexmatch_cifar100_200_0.yaml") for p in YAMLS)


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_loads_to_equal_fields(path):
    a = dataclasses.asdict(jax_from_yaml(path))
    b = dataclasses.asdict(torch_from_yaml(path))
    assert a == b


def test_overrides_coerce_alike():
    path = YAMLS[0]
    ov = {"dataset": "synthetic", "use_pretrain": "False", "resume": "False",
          "num_train_iter": "40", "start_timing": "10", "N_k": "10",
          "lr": "0.001", "mesh_shape": "(1,)"}
    assert (dataclasses.asdict(jax_from_yaml(path, dict(ov)))
            == dataclasses.asdict(torch_from_yaml(path, dict(ov))))
