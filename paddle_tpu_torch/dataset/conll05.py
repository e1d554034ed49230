"""Legacy CoNLL-05 SRL readers (``paddle.dataset.conll05``).

Reference: ``python/paddle/dataset/conll05.py:49-265``. Delegates to
``paddle_tpu_torch.text.datasets.Conll05st`` (same 9-tuple sample schema).
Conventional files under ``DATA_HOME/conll05st/``:
``conll05st-tests.tar.gz``, ``wordDict.txt``, ``verbDict.txt``,
``targetDict.txt``, and (for :func:`get_embedding`) ``emb``.
"""
from __future__ import annotations

import numpy as np

from . import common

__all__ = []


def _dataset():
    from ..text.datasets import Conll05st

    return Conll05st(
        data_file=common.local_path("conll05st", "conll05st-tests.tar.gz"),
        word_dict_file=common.local_path("conll05st", "wordDict.txt"),
        verb_dict_file=common.local_path("conll05st", "verbDict.txt"),
        target_dict_file=common.local_path("conll05st", "targetDict.txt"))


def get_dict():
    """(word_dict, verb_dict, label_dict) of the corpus."""
    ds = _dataset()
    return ds.word_dict, ds.predicate_dict, ds.label_dict


def get_embedding():
    """The pre-trained word embedding table (float32 [vocab, dim]),
    whitespace-separated rows in the conventional ``emb`` file."""
    path = common.local_path("conll05st", "emb")
    return np.loadtxt(path, dtype=np.float32)


def test():
    """Test-section reader creator yielding the reference's 9-tuple
    (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred, mark, label)."""
    ds = _dataset()

    def reader():
        for sample in ds:
            yield tuple(sample)

    return reader


def fetch():
    _dataset()
