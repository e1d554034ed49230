"""``text`` of the port against the reference's on the CPU: the seven
corpus datasets on the same files (same samples, dictionaries and typed
errors), the WordPiece tokenizer (native and Python, in and out of
``DataLoader`` workers: the same ids), and one ``Model.fit`` step of a
small ERNIE classifier (2 layers, hidden 64) on an ``Imdb`` batch from
the same weights (``load_reference_params``).

Tolerances: samples, dictionaries and ids are equal; the losses of two
``train_batch`` steps (fp32, AdamW at learning rate 1e-3) within 1e-5 of
the reference's, and the logits after them within 1e-4 of their largest
magnitude.  The parameters are compared through the logits: a key
projection's bias has a gradient that is zero up to rounding (softmax
ignores a shift of every key), which Adam's ``m / sqrt(v)`` turns into a
step of either sign in each package.
"""
import os

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.text as rtext
from paddle_tpu.core.errors import InvalidArgumentError as RefInvalid

import paddle_tpu_torch as ptt
import paddle_tpu_torch.text as ptext
from paddle_tpu_torch.core.errors import InvalidArgumentError

from torch_data import (assert_same, dataset_items, write_conll05,
                        write_imdb, write_imikolov, write_movielens_tar,
                        write_uci, write_vocab, write_wmt14, write_wmt16)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Every corpus once, written from numpy seed 0."""
    d = str(tmp_path_factory.mktemp("corpora"))
    rng = np.random.RandomState(0)
    out = {"imdb": write_imdb(os.path.join(d, "aclImdb_v1.tar.gz"), rng),
           "imikolov": write_imikolov(os.path.join(d, "simple-examples.tgz")),
           "uci": write_uci(os.path.join(d, "housing.data"), rng),
           "movielens": write_movielens_tar(os.path.join(d, "ml-1m.tar.gz")),
           "wmt14": write_wmt14(os.path.join(d, "wmt14.tgz")),
           "wmt16": write_wmt16(os.path.join(d, "wmt16.tar.gz")),
           "conll05": write_conll05(d)}
    return out


# (name, corpus, constructor keyword arguments, attributes to compare)
DATASET_CASES = [
    ("Imdb", "imdb", dict(mode="train", cutoff=2), ("word_idx",)),
    ("Imdb", "imdb", dict(mode="test", cutoff=3), ("word_idx",)),
    ("Imikolov", "imikolov", dict(mode="train", data_type="ngram",
                                  window_size=3, min_word_freq=10),
     ("word_idx",)),
    ("Imikolov", "imikolov", dict(mode="valid", data_type="seq",
                                  min_word_freq=1), ("word_idx",)),
    ("UCIHousing", "uci", dict(mode="train"), ()),
    ("UCIHousing", "uci", dict(mode="test"), ()),
    ("Movielens", "movielens", dict(mode="train", test_ratio=0.25), ()),
    ("Movielens", "movielens", dict(mode="test", test_ratio=0.25), ()),
    ("WMT14", "wmt14", dict(mode="train"), ()),
    ("WMT14", "wmt14", dict(mode="test"), ()),
    ("WMT16", "wmt16", dict(mode="train"), ("src_dict", "trg_dict")),
    ("WMT16", "wmt16", dict(mode="val", lang="de"), ("src_dict",
                                                    "trg_dict")),
    ("WMT16", "wmt16", dict(mode="train", src_dict_size=4),
     ("src_dict",)),
    ("Conll05st", "conll05", {}, ("word_dict", "label_dict")),
]


def _build(pkg, name, corpus, kw):
    files = corpus if isinstance(corpus, dict) else {"data_file": corpus}
    return getattr(pkg, name)(**files, **kw)


@pytest.mark.parametrize("name,key,kw,attrs", DATASET_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(DATASET_CASES)])
def test_dataset_samples_match_the_reference(corpora, name, key, kw, attrs):
    ref = _build(rtext, name, corpora[key], kw)
    port = _build(ptext, name, corpora[key], kw)
    assert len(port) == len(ref) > 0
    assert_same(dataset_items(port), dataset_items(ref))
    for a in attrs:
        assert_same(getattr(port, a), getattr(ref, a), a)


@pytest.mark.parametrize("name", ["Imdb", "Imikolov", "UCIHousing",
                                  "Movielens", "WMT14", "WMT16"])
def test_dataset_refusals_match_the_reference(corpora, name):
    """No data file: both raise their InvalidArgumentError; a bad mode
    too where the reference checks it."""
    with pytest.raises(RefInvalid):
        getattr(rtext, name)()
    with pytest.raises(InvalidArgumentError):
        getattr(ptext, name)()
    if name == "Imdb":
        with pytest.raises(RefInvalid):
            rtext.Imdb(data_file=corpora["imdb"], mode="dev")
        with pytest.raises(InvalidArgumentError):
            ptext.Imdb(data_file=corpora["imdb"], mode="dev")


# -- the tokenizer ------------------------------------------------------------

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown", "fox",
         "jump", "##ed", "##s", "over", "lazy", "dog", ",", ".", "un",
         "##believ", "##able", "!", "w1", "w2", "##3"]
TEXTS = ["The quick brown fox jumped over the lazy dog.",
         "jumps, jumped. THE LAZY dog", "unknownword fox", "", "  ,  . ",
         "fox" * 60, "unbelievable! w1 w23 w2", "Ünïcode fox naïve"]


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return write_vocab(str(tmp_path_factory.mktemp("vocab") / "vocab.txt"),
                       VOCAB)


def test_load_vocab_matches_the_reference(vocab_path):
    assert ptext.load_vocab(vocab_path) == rtext.load_vocab(vocab_path)


def test_native_tokenizer_builds_under_the_package():
    assert ptext.native_available()
    from paddle_tpu_torch.text import tokenizer

    assert os.path.basename(os.path.dirname(tokenizer._SO_PATH)) == "_build"
    assert os.path.dirname(os.path.dirname(tokenizer._SO_PATH)) == \
        os.path.dirname(os.path.abspath(ptt.__file__))


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("lower", [True, False])
def test_tokenizer_ids_match_the_reference(vocab_path, use_native, lower):
    vocab = ptext.load_vocab(vocab_path)
    ref = rtext.WordpieceTokenizer(vocab, do_lower_case=lower,
                                   use_native=False)
    port = ptext.WordpieceTokenizer(vocab, do_lower_case=lower,
                                    use_native=use_native)
    assert (port._handle is not None) == use_native
    for text in TEXTS:
        want = ref.tokenize(text)
        got = port.tokenize(text)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=repr(text))


class _TokenDataset(ptt.io.Dataset):
    """Each text tokenized natively in the worker, padded to 16 ids."""

    def __init__(self, tok, texts):
        self.tok, self.texts = tok, texts

    def __len__(self):
        return len(self.texts)

    def __getitem__(self, i):
        ids = self.tok.tokenize(self.texts[i])[:16]
        out = np.zeros(16, np.int32)
        out[:len(ids)] = ids
        return out


def test_tokenizer_in_loader_workers_matches_the_reference(vocab_path):
    vocab = ptext.load_vocab(vocab_path)
    texts = TEXTS * 2
    ref = rtext.WordpieceTokenizer(vocab, use_native=False)
    want = np.zeros((len(texts), 16), np.int32)
    for i, t in enumerate(texts):
        ids = ref.tokenize(t)[:16]
        want[i, :len(ids)] = ids
    loader = ptt.io.DataLoader(
        _TokenDataset(ptext.WordpieceTokenizer(vocab), texts),
        batch_size=4, num_workers=2, device="cpu")
    got = np.concatenate([b.numpy() for b in loader])
    np.testing.assert_array_equal(got, want)


# -- one fit step of a small ERNIE classifier on an Imdb batch ---------------

SEQ = 32
ERNIE_SMALL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                   intermediate_size=128, max_position=64, causal=False,
                   type_vocab_size=4)


def imdb_samples(ds, n):
    """(ids [n, SEQ] padded with 0 or cut, additive mask [n, 1, 1, SEQ],
    token types, labels) of the first ``n`` reviews of both classes."""
    idx = np.r_[0:n // 2, len(ds) - n // 2:len(ds)]
    ids = np.zeros((n, SEQ), np.int64)
    mask = np.full((n, 1, 1, SEQ), np.finfo(np.float32).min, np.float32)
    labels = np.zeros((n,), np.int64)
    for row, i in enumerate(idx):
        doc, label = ds[int(i)]
        k = min(len(doc), SEQ)
        ids[row, :k] = doc[:k]
        mask[row, ..., :k] = 0.0
        labels[row] = label
    return ids, mask, np.zeros_like(ids), labels


def test_ernie_fit_step_on_imdb_matches_the_reference(corpora):
    from paddle_tpu.models import TransformerForSequenceClassification as Ref

    ds_ref = rtext.Imdb(data_file=corpora["imdb"], cutoff=1)
    ds = ptext.Imdb(data_file=corpora["imdb"], cutoff=1)
    assert len(ds.word_idx) < ERNIE_SMALL["vocab_size"]
    arrays = imdb_samples(ds, 4)
    for a, b in zip(arrays, imdb_samples(ds_ref, 4)):
        np.testing.assert_array_equal(a, b)
    pt.seed(0)
    ref_net = Ref(num_classes=2, dropout=0.0, **ERNIE_SMALL)
    net = ptt.TransformerForSequenceClassification(
        num_classes=2, dropout=0.0, device="cpu", **ERNIE_SMALL)
    ptt.load_reference_params(net, {n: np.asarray(p.value)
                                    for n, p in ref_net.named_parameters()})
    ref = pt.Model(ref_net)
    ref.prepare(pt.optimizer.AdamW(1e-3, parameters=ref_net.parameters()),
                pt.nn.CrossEntropyLoss())
    port = ptt.Model(net, device="cpu")
    port.prepare(ptt.optimizer.AdamW(1e-3, parameters=net.parameters()),
                 ptt.nn.CrossEntropyLoss())
    ids, mask, types, labels = arrays
    for _ in range(2):
        want = float(np.asarray(ref.train_batch([ids, mask, types],
                                                [labels])[0]))
        got = float(np.asarray(port.train_batch([ids, mask, types],
                                                [labels])[0]))
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (got, want)
    want = np.asarray(ref.predict_batch([ids, mask, types])[0])
    got = np.asarray(port.predict_batch([ids, mask, types])[0])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
