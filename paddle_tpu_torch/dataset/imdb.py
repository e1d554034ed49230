"""Legacy IMDB sentiment readers (``paddle.dataset.imdb``).

Reference: ``python/paddle/dataset/imdb.py:40-150``. Legacy semantics
kept exactly: punctuation-stripped lowercase tokenization, frequency
``> cutoff`` vocabulary ranked by (-freq, word) with ``<unk>`` last, and
labels pos=0 / neg=1 (note the modern ``text.datasets.Imdb`` uses the
opposite convention, neg=0/pos=1). Place ``aclImdb_v1.tar.gz`` in
``DATA_HOME/imdb/``.
"""
from __future__ import annotations

import collections
import re
import string
import tarfile

from . import common

__all__ = []

_PUNCT = bytes(string.punctuation, "ascii")


def _tar_path():
    return common.local_path("imdb", "aclImdb_v1.tar.gz")


def tokenize(pattern):
    """Yield the punctuation-stripped lowercase token list of every tar
    member matching ``pattern`` (sequential tar walk)."""
    with tarfile.open(_tar_path()) as tarf:
        member = tarf.next()
        while member is not None:
            if pattern.match(member.name):
                raw = tarf.extractfile(member).read().rstrip(b"\n\r")
                yield raw.translate(None, _PUNCT).lower().split()
            member = tarf.next()


def build_dict(pattern, cutoff):
    """Zero-based word ids for words with frequency > ``cutoff``, ranked
    by (-freq, word); ``<unk>`` gets the last id."""
    word_freq = collections.defaultdict(int)
    for doc in tokenize(pattern):
        for word in doc:
            word_freq[word] += 1
    kept = sorted(((w, c) for w, c in word_freq.items() if c > cutoff),
                  key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx[b"<unk>"] = len(kept)
    return word_idx


def reader_creator(pos_pattern, neg_pattern, word_idx):
    unk = word_idx[b"<unk>"]
    samples = []

    def load(pattern, label):
        for doc in tokenize(pattern):
            samples.append(([word_idx.get(w, unk) for w in doc], label))

    load(pos_pattern, 0)
    load(neg_pattern, 1)

    def reader():
        yield from samples

    return reader


def train(word_idx):
    """Train reader creator: (word-id list, label) with pos=0, neg=1."""
    return reader_creator(
        re.compile(r"aclImdb/train/pos/.*\.txt$"),
        re.compile(r"aclImdb/train/neg/.*\.txt$"), word_idx)


def test(word_idx):
    """Test reader creator: (word-id list, label) with pos=0, neg=1."""
    return reader_creator(
        re.compile(r"aclImdb/test/pos/.*\.txt$"),
        re.compile(r"aclImdb/test/neg/.*\.txt$"), word_idx)


def word_dict():
    """The corpus vocabulary (train+test, both polarities, cutoff 150)."""
    return build_dict(
        re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"), 150)


def fetch():
    _tar_path()
