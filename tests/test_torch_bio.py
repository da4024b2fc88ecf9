"""Bio/DNA data and the DNABERT nets in the port, held against the JAX
package (``semireward_tpu/data/bio.py``, ``models/huggingface.py``).

- k-mer ids (specials, ``[UNK]`` for any letter outside A/C/G/T,
  lowercase), the base complement, the CSV reader (header and short rows
  skipped) and ``BioCollator`` bit-equal to JAX's on the seeded corpus of
  ``write_synthetic_bio``, with a planted ``N`` base and a short sequence;
- ``get_bio_dataset``'s labeled / unlabeled / eval / test splits bit-equal;
- the NLP loader's per-view branch (a collator without ``collate_views``)
  gives JAX's batches for FlexMatch's and ReMixMatch's keys;
- ``dnabert_2_117m`` and ``hf_text_classifier`` converted from the flax
  builders' trees give their logits and features within 1e-5 (float32,
  small geometry);
- two CPU Trainer steps of the usb_nlp FlexMatch YAML with ``net
  dnabert_2_117m`` on the corpus, an eval and the after-run test eval.
"""
import csv
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_rel_close
from semireward_tpu.config import get_config as jax_config
from semireward_tpu.data import bio as jbio
from semireward_tpu.data import modality as jmod
from semireward_tpu.models import huggingface as jhf
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.convert import load_flax_params
from semireward_tpu_torch.data import bio as tbio
from semireward_tpu_torch.data import modality as tmod
from semireward_tpu_torch.models import huggingface as thf
from semireward_tpu_torch import algorithms as _algorithms  # noqa: F401
from semireward_tpu_torch import models as _models  # noqa: F401
from semireward_tpu_torch.registry import NETS

NC, L = 3, 64
GEOM = dict(hidden=64, layers=2, heads=2, intermediate=128, max_position=L)


@pytest.fixture
def corpus(tmp_path):
    root = tbio.write_synthetic_bio(
        str(tmp_path), "dna", num_classes=NC, length=(20, 90),
        sizes=(("train", 60), ("dev", 12), ("test", 6)))
    assert tbio.write_synthetic_bio(str(tmp_path), "dna") == root
    # a lowercase sequence with an N base, and one shorter than k
    with open(f"{root}/train.csv", "a", newline="") as f:
        csv.writer(f).writerows([["acgtNacgtacgtTT", 1], ["ACG", 2],
                                 ["bad row"]])
    return str(tmp_path)


def test_kmers_complement_and_csv_are_bit_equal(corpus):
    seqs = ["ACGTACGTAC", "acgtNacgt", "TTTTTT", "ACG", "GATTACA" * 20]
    for s in seqs:
        for k in (3, 6):
            assert tbio.seq_to_kmers(s, k) == jbio.seq_to_kmers(s, k)
            assert [tbio.kmer_to_id(m, k) for m in tbio.seq_to_kmers(s, k)] \
                == [jbio.kmer_to_id(m, k) for m in jbio.seq_to_kmers(s, k)]
        assert tbio.complement(s) == jbio.complement(s)
    assert tbio.kmer_to_id("AAAAAA") == 5
    assert tbio.kmer_to_id("TTTTTT") == 5 + 4 ** 6 - 1 == 4100
    assert tbio.kmer_to_id("ACNTTT") == tbio.UNK_ID == 4
    got = tbio.load_csv_dataset(corpus, "dna", k=6, max_length=L)
    want = jbio.load_csv_dataset(corpus, "dna", k=6, max_length=L)
    for split in ("train", "dev", "test"):
        assert got[split].seqs == want[split].seqs
        np.testing.assert_array_equal(got[split].targets,
                                      want[split].targets)
        for i in range(len(got[split])):
            np.testing.assert_array_equal(got[split].encode(i),
                                          want[split].encode(i))
    assert len(got["train"]) == 62 and got["train"].seqs[-1] == "ACG"
    tcol, jcol = tbio.BioCollator(6, L), jbio.BioCollator(6, L)
    idx = np.arange(len(got["train"]))
    for strong in (False, True):
        a = tcol.views(got["train"], idx, None, strong)
        b = jcol.views(want["train"], idx, None, strong)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].shape == (62, L) and a[k].dtype == np.int32
    assert a["input_ids"][-1, :2].tolist() == [tbio.CLS_ID, tbio.SEP_ID]


def _cfg(corpus, **kw):
    return dict(dataset="dna", data_dir=corpus, num_classes=NC, num_labels=9,
                max_length=L, seed=3, net="dnabert_2_117m", **kw)


def test_bio_splits_and_loader_batches_are_bit_equal(corpus):
    from semireward_tpu_torch.registry import ALGORITHMS as TALGS

    got = tbio.get_bio_dataset(torch_config(**_cfg(corpus)))
    want = jbio.get_bio_dataset(jax_config(**_cfg(corpus)))
    for split in ("train_lb", "train_ulb", "eval", "test"):
        assert got[split].seqs == want[split].seqs, split
        np.testing.assert_array_equal(got[split].targets,
                                      want[split].targets)
    assert sorted(np.bincount(got["train_lb"].targets)) == [3, 3, 3]
    for algo in ("flexmatch", "remixmatch"):
        keys = TALGS.get(algo).BATCH_KEYS
        tl = tmod.NLPSSLLoader(got, tbio.BioCollator(6, L), 4, 8, keys,
                               seed=5)
        jl = jmod.NLPSSLLoader(want, jbio.BioCollator(6, L), 4, 8, keys,
                               seed=5)
        for step in range(3):
            a, b = next(tl), next(jl)
            assert sorted(a) == sorted(b)
            assert {k for k in a if k.startswith("x_")} == {
                k for k in keys if k.startswith("x_")}
            for k in b:
                if isinstance(b[k], dict):
                    for kk in b[k]:
                        np.testing.assert_array_equal(a[k][kk], b[k][kk])
                else:
                    np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["dnabert_2_117m", "hf_text_classifier"])
def test_text_builders_convert_and_match_jax(name):
    kw = (dict(GEOM) if name == "dnabert_2_117m"
          else dict(vocab_size=500, hidden=64, layers=2, heads=2))
    jnet = getattr(jhf, name)(num_classes=NC, dtype=jnp.float32, **kw)
    tnet = NETS.get(name)(NC, dtype=torch.float32, **kw)
    assert getattr(thf, name).num_layers == 13 == getattr(jhf, name).num_layers
    vocab = 4101 if name == "dnabert_2_117m" else 500
    assert tnet.word_embeddings.weight.shape == (vocab, 64)
    rs = np.random.RandomState(0)
    n = L if name == "dnabert_2_117m" else 48
    ids = rs.randint(5, vocab, (3, n)).astype(np.int32)
    mask = (np.arange(n)[None] < np.array([[n], [30], [9]])).astype(np.int32)
    x = {"input_ids": ids * mask, "attention_mask": mask}
    params = jax.jit(lambda k: jnet.init(k, jax.tree_util.tree_map(
        jnp.asarray, x), train=False))(jax.random.PRNGKey(0))["params"]
    load_flax_params(tnet, jax.device_get(params))
    want = jax.jit(lambda p, x: jnet.apply({"params": p}, x, train=False))(
        params, jax.tree_util.tree_map(jnp.asarray, x))
    got = tnet({k: torch.from_numpy(v) for k, v in x.items()}, train=False)
    for k in ("logits", "feat"):
        assert_rel_close(got[k], np.asarray(want[k]), 1e-5, k)
    from semireward_tpu.models.bert import _layer_id as jlayer
    for n_, _ in tnet.named_parameters():
        jname = n_.replace("layer.", "layer").split(".")
        assert getattr(thf, name).layer_id_fn(n_.split("."), 13) == \
            jlayer(jname, 13), n_


def test_trainer_trains_dnabert_on_the_bio_corpus(corpus, tmp_path):
    """The usb_nlp FlexMatch YAML with ``net dnabert_2_117m`` on the CSV
    corpus, a small geometry, two steps on the CPU: the bio loader and
    collator, the k-mer views of ``max_length`` on both sides, an eval and
    the test split's eval of the best weights."""
    from semireward_tpu_torch import config as config_lib
    from semireward_tpu_torch.core.trainer import Trainer

    cfg = config_lib.from_yaml(
        "config/usb_nlp/flexmatch/flexmatch_aclImdb_100_0.yaml", dict(
            net="dnabert_2_117m", dataset="dna", data_dir=corpus,
            num_classes=NC, num_labels=9, max_length=L, batch_size=3,
            eval_batch_size=8, num_train_iter=2, num_eval_iter=2,
            num_log_iter=1, use_pretrain=False, resume=False,
            compute_dtype="float32", save_dir=str(tmp_path / "out"),
            net_kwargs=GEOM, use_fused_mlp=False))
    tr = Trainer(cfg, device="cpu")
    assert type(tr.collator).__name__ == "BioCollator"
    assert tr.model.word_embeddings.weight.shape[0] == 4101
    batch = next(tr._make_loader())
    assert batch["x_ulb_s"]["input_ids"].shape == (3, L)
    results = tr.train()
    assert tr.state.step == 2
    assert all(math.isfinite(v) for v in results.values())
    assert "test/top-1-acc" in results
