"""Splits, synthetic data and index streams: the port's numpy copies give
exactly the JAX package's arrays for the same seed."""
import numpy as np
import pytest

from semireward_tpu.config import get_config as jax_config
from semireward_tpu.data import datasets as JD
from semireward_tpu.data import loader as JLd
from semireward_tpu.data import split as JS
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.data import datasets as TD
from semireward_tpu_torch.data import loader as TLd
from semireward_tpu_torch.data import split as TS


@pytest.mark.parametrize("kw", [
    dict(lb_num_labels=40),
    dict(lb_num_labels=40, include_lb_to_ulb=False),
    dict(lb_num_labels=100, lb_imbalance_ratio=10.0, ulb_num_labels=300,
         ulb_imbalance_ratio=10.0),
])
def test_split_ssl_data_exact(kw):
    rs = np.random.RandomState(0)
    data = rs.randint(0, 256, (600, 4, 4, 3)).astype(np.uint8)
    targets = rs.randint(0, 10, 600)
    a = JS.split_ssl_data(data, targets, 10, rng=np.random.RandomState(3), **kw)
    b = TS.split_ssl_data(data, targets, 10, rng=np.random.RandomState(3), **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_synthetic_exact():
    for kw in (dict(), dict(class_sim=0.5, proto_scale=4)):
        a = JD.make_synthetic(10, 16, 64, 32, seed=1, **kw)
        b = TD.make_synthetic(10, 16, 64, 32, seed=1, **kw)
        for (xa, ya), (xb, yb) in zip(a, b):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_infinite_indices_exact():
    ja = JLd.infinite_indices(37, seed=5)
    tb = TLd.infinite_indices(37, seed=5)
    assert [next(ja) for _ in range(200)] == [next(tb) for _ in range(200)]


def test_bundle_loader_and_eval_batches_exact():
    kw = dict(dataset="synthetic", num_classes=10, num_labels=40,
              synthetic_train=256, synthetic_test=40, seed=2)
    jb = JD.get_dataset(jax_config(**kw))
    tb = TD.get_dataset(torch_config(**kw))
    assert (jb.mean, jb.std, jb.ulb_dest_len) == (tb.mean, tb.std,
                                                  tb.ulb_dest_len)
    jl = JLd.SSLLoader(jb, 8, 8, seed=2)
    tl = TLd.SSLLoader(tb, 8, 8, seed=2)
    for _ in range(30):
        a, b = next(jl), next(tl)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(JLd.eval_batches(jb.eval, 16),
                    TLd.eval_batches(tb.eval, 16)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
