"""NLP data of the port (``data/nlp.py``, ``data/modality.py``, numpy-only
copies) against the JAX package on a tiny JSON corpus: the dataset split,
the tokenizer, the length buckets, ``collate_views`` and ``NLPSSLLoader``
give bit-equal batches for the same seeds."""
import json
import sys
import types

import numpy as np
import pytest

from semireward_tpu.config import get_config as jax_config
from semireward_tpu.data import modality as jmod
from semireward_tpu.data import nlp as jnlp
from semireward_tpu_torch.config import get_config as torch_config
from semireward_tpu_torch.data import modality as tmod
from semireward_tpu_torch.data import nlp as tnlp

KEYS = ("x_lb", "y_lb", "idx_ulb", "x_ulb_w", "x_ulb_s")


def write_corpus(root, name="aclImdb", n_train=40, seed=0):
    """{train,dev,test}.json in the aclImdb layout: 2 classes, lengths from
    a few words to past 128 tokens, a label readable from the words."""
    base = root / name
    base.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    for split, count in (("train", n_train), ("dev", 12), ("test", 6)):
        d = {}
        for i in range(count):
            y = int(rs.randint(2))
            n = int(rs.choice([6, 30, 70, 150]))
            words = [f"{'pos' if y else 'neg'}{rs.randint(5)}"
                     if rs.rand() < 0.3 else f"w{rs.randint(200)}"
                     for _ in range(n)]
            text = " ".join(words)
            d[str(i)] = {"ori": text, "aug_0": text + " again",
                         "aug_1": "so " + text, "label": y}
        (base / f"{split}.json").write_text(json.dumps(d))
    return str(root)


def assert_batches_equal(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        if isinstance(a[k], dict):
            assert_batches_equal(a[k], b[k], f"{what}.{k}")
        else:
            assert a[k].dtype == b[k].dtype, (what, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}.{k}")


def test_dataset_split_and_json_loading(tmp_path):
    root = write_corpus(tmp_path)
    kw = dict(algorithm="srflexmatch", dataset="aclImdb", data_dir=root,
              num_classes=2, num_labels=8, seed=3)
    want = jnlp.get_nlp_dataset(jax_config(**kw), "srflexmatch")
    got = tnlp.get_nlp_dataset(torch_config(**kw), "srflexmatch")
    for split in ("train_lb", "train_ulb", "eval", "test"):
        assert got[split].texts == want[split].texts, split
        assert got[split].augs == want[split].augs, split
        np.testing.assert_array_equal(got[split].targets,
                                      want[split].targets)


@pytest.mark.parametrize("max_length", [32, 64, 100, 128, 256, 512])
def test_buckets_and_tokenizer(max_length):
    assert tnlp.auto_buckets(max_length) == jnlp.auto_buckets(max_length)
    tcol = tnlp.NLPCollator(tnlp.HashTokenizer(), max_length,
                            tnlp.auto_buckets(max_length))
    jcol = jnlp.NLPCollator(jnlp.HashTokenizer(), max_length,
                            jnlp.auto_buckets(max_length))
    assert tcol.buckets == jcol.buckets
    for n in (1, 2, 63, 64, 65, 200, 600):
        assert tcol.bucket_for(n) == jcol.bucket_for(n)
    texts = ["", "one", "Some Words here", " ".join(f"w{i}" for i in range(300))]
    for t in texts:
        np.testing.assert_array_equal(
            tnlp.HashTokenizer().encode(t, max_length),
            jnlp.HashTokenizer().encode(t, max_length))
    assert_batches_equal(tcol(texts), jcol(texts), "collate")


def test_get_tokenizer_gives_the_same_ids(monkeypatch):
    """Without ``transformers`` (hidden here: with no local vocabulary it
    falls back either way, and importing it costs seconds) both packages
    take the hash tokenizer."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    t, j = tnlp.get_tokenizer("bert_base_uncased"), \
        jnlp.get_tokenizer("bert_base_uncased")
    assert type(t).__name__ == type(j).__name__ == "HashTokenizer"
    for text in ("a short review", "Another, longer one: it was great!"):
        np.testing.assert_array_equal(t.encode(text, 16), j.encode(text, 16))


def test_get_tokenizer_wraps_a_local_vocabulary(monkeypatch):
    """With a local vocabulary both packages wrap the same AutoTokenizer the
    same way; a stand-in ``transformers`` plays the HF tokenizer."""
    asked = []

    class StandIn:
        def __call__(self, text, max_length, truncation, padding=None):
            assert truncation
            ids = [101] + [1000 + len(w) for w in text.split()][
                :max_length - 2] + [102]
            if padding == "max_length":
                ids += [0] * (max_length - len(ids))
            return {"input_ids": ids}

    def from_pretrained(path, local_files_only):
        asked.append((path, local_files_only))
        return StandIn()

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=from_pretrained)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    t, j = tnlp.get_tokenizer("bert_base_uncased"), \
        jnlp.get_tokenizer("bert_base_uncased")
    assert asked == [("bert-base-uncased", True)] * 2
    for text in ("a short review", " ".join(["word"] * 40)):
        assert t.encode_ids(text, 16) == j.encode_ids(text, 16)
        got, want = t.encode(text, 16), j.encode(text, 16)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_collate_views_bit_equal(tmp_path):
    root = write_corpus(tmp_path)
    tds = tnlp.load_json_dataset(root, "aclImdb")["train"]
    jds = jnlp.load_json_dataset(root, "aclImdb")["train"]
    tcol = tnlp.NLPCollator(tnlp.HashTokenizer(), 256, tnlp.auto_buckets(256))
    jcol = jnlp.NLPCollator(jnlp.HashTokenizer(), 256, jnlp.auto_buckets(256))
    trs, jrs = np.random.RandomState(7), np.random.RandomState(7)
    for step in range(4):
        li, ui = np.arange(step, step + 4), np.arange(10 + step, 16 + step)
        keys = ("x_lb", "x_lb_s", "x_ulb_w", "x_ulb_s_0", "x_ulb_s_1")
        assert_batches_equal(
            tcol.collate_views(tds, tds, li, ui, keys, trs),
            jcol.collate_views(jds, jds, li, ui, keys, jrs), f"step {step}")


@pytest.mark.parametrize("max_length", [128, 512])
def test_nlp_ssl_loader_bit_equal(tmp_path, max_length):
    root = write_corpus(tmp_path)
    kw = dict(algorithm="srflexmatch", dataset="aclImdb", data_dir=root,
              num_classes=2, num_labels=8, seed=0)
    tsp = tnlp.get_nlp_dataset(torch_config(**kw), "srflexmatch")
    jsp = jnlp.get_nlp_dataset(jax_config(**kw), "srflexmatch")
    tcol = tnlp.NLPCollator(tnlp.HashTokenizer(), max_length,
                            tnlp.auto_buckets(max_length))
    jcol = jnlp.NLPCollator(jnlp.HashTokenizer(), max_length,
                            jnlp.auto_buckets(max_length))
    tl = tmod.NLPSSLLoader(tsp, tcol, 4, 4, KEYS, seed=5)
    jl = jmod.NLPSSLLoader(jsp, jcol, 4, 4, KEYS, seed=5)
    for step in range(6):
        assert_batches_equal(next(tl), next(jl), f"step {step}")


def test_bundle_and_modality():
    for net in ("bert_base_uncased", "dnabert", "hubert_base",
                "wave2vecv2_base", "vit_small_patch2_32"):
        assert tmod.modality_of(net) == jmod.modality_of(net)
    splits = {"train_lb": [1, 2], "train_ulb": [1, 2, 3], "eval": []}
    t, j = tmod.GenericBundle(splits, 2), jmod.GenericBundle(splits, 2)
    assert (t.ulb_dest_len, t.lb_dest_len, t.mean, t.std) == \
        (j.ulb_dest_len, j.lb_dest_len, j.mean, j.std)


def test_synthetic_corpus_is_seeded_and_fills_the_512_bucket(tmp_path):
    """The smoke run's corpus: the same bytes from the same seed, the
    aclImdb layout that both packages load to the same splits, two balanced
    classes whose cue words name the label, IMDB-like lengths so that most
    12-text step batches pad to 512 tokens."""
    a = tnlp.write_synthetic_corpus(str(tmp_path / "a"),
                                    sizes=(("train", 200), ("dev", 16),
                                           ("test", 8)))
    b = tnlp.write_synthetic_corpus(str(tmp_path / "b"),
                                    sizes=(("train", 200), ("dev", 16),
                                           ("test", 8)))
    for split in ("train", "dev", "test"):
        assert (tmp_path / "a" / "aclImdb" / f"{split}.json").read_bytes() \
            == (tmp_path / "b" / "aclImdb" / f"{split}.json").read_bytes()
    kw = dict(algorithm="srflexmatch", dataset="aclImdb",
              data_dir=str(tmp_path / "a"), num_classes=2, num_labels=20)
    got = tnlp.get_nlp_dataset(torch_config(**kw), "srflexmatch")
    want = jnlp.get_nlp_dataset(jax_config(**kw), "srflexmatch")
    assert got["train_ulb"].texts == want["train_ulb"].texts
    train = tnlp.load_json_dataset(a.rsplit("/", 1)[0], "aclImdb")["train"]
    assert 0.4 < train.targets.mean() < 0.6
    with_cues = 0
    for text, y in zip(train.texts, train.targets):
        cues = [w for w in text.split() if w.startswith("c")]
        assert all(w.startswith(f"c{y}x") for w in cues)
        with_cues += bool(cues)
    assert with_cues >= 0.95 * len(train)
    col = tnlp.NLPCollator(tnlp.HashTokenizer(), 512, tnlp.auto_buckets(512))
    loader = tmod.NLPSSLLoader(got, col, 4, 4, KEYS, seed=0)
    widths = [next(loader)["x_lb"]["input_ids"].shape[1] for _ in range(40)]
    assert np.mean(np.asarray(widths) == 512) > 0.8
