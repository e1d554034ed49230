"""Legacy PTB (imikolov) readers (``paddle.dataset.imikolov``).

Reference: ``python/paddle/dataset/imikolov.py:42-168``. N-gram windows
or (src, trg) id sequences over the Penn Treebank simple-examples
archive; vocabulary from train+valid with frequency ``> min_word_freq``,
``<unk>`` last. Place ``simple-examples.tgz`` in ``DATA_HOME/imikolov/``.
"""
from __future__ import annotations

import collections
import tarfile

from . import common

__all__ = []


class DataType:
    NGRAM = 1
    SEQ = 2


def _tar_path():
    return common.local_path("imikolov", "simple-examples.tgz")


def _extract(tf, filename):
    names = tf.getnames()
    if filename not in names and filename.startswith("./") \
            and filename[2:] in names:
        filename = filename[2:]
    return tf.extractfile(filename)


def word_count(f, word_freq=None):
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for line in f:
        for w in line.strip().split():
            word_freq[w] += 1
        word_freq[b"<s>"] += 1
        word_freq[b"<e>"] += 1
    return word_freq


def build_dict(min_word_freq=50):
    """Vocabulary over ptb.train + ptb.valid: ids ranked by (-freq, word)
    for frequency > ``min_word_freq``; ``<unk>`` last."""
    with tarfile.open(_tar_path()) as tf:
        trainf = _extract(tf, "./simple-examples/data/ptb.train.txt")
        validf = _extract(tf, "./simple-examples/data/ptb.valid.txt")
        word_freq = word_count(validf, word_count(trainf))
    word_freq.pop(b"<unk>", None)
    kept = sorted(((w, c) for w, c in word_freq.items()
                   if c > min_word_freq), key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx[b"<unk>"] = len(kept)
    return word_idx


def reader_creator(filename, word_idx, n, data_type):
    def reader():
        with tarfile.open(_tar_path()) as tf:
            f = _extract(tf, filename)
            unk = word_idx[b"<unk>"]
            for line in f:
                if data_type == DataType.NGRAM:
                    if n <= 0:
                        raise ValueError("Invalid gram length")
                    words = [b"<s>"] + line.strip().split() + [b"<e>"]
                    if len(words) >= n:
                        ids = [word_idx.get(w, unk) for w in words]
                        for i in range(n, len(ids) + 1):
                            yield tuple(ids[i - n:i])
                elif data_type == DataType.SEQ:
                    ids = [word_idx.get(w, unk)
                           for w in line.strip().split()]
                    src = [word_idx[b"<s>"]] + ids
                    trg = ids + [word_idx[b"<e>"]]
                    if n > 0 and len(src) > n:
                        continue
                    yield src, trg
                else:
                    raise ValueError("Unknown data type %r" % data_type)

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    """Train reader creator (ptb.train.txt)."""
    return reader_creator("./simple-examples/data/ptb.train.txt", word_idx,
                          n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    """Test reader creator (ptb.valid.txt, as in the reference)."""
    return reader_creator("./simple-examples/data/ptb.valid.txt", word_idx,
                          n, data_type)


def fetch():
    _tar_path()
