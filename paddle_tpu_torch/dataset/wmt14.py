"""Legacy WMT14 en→fr readers (``paddle.dataset.wmt14``).

Reference: ``python/paddle/dataset/wmt14.py:52-190``. Delegates to
``paddle_tpu_torch.text.datasets.WMT14`` (same (src, trg, trg_next) samples
with <s>/<e>/<unk> framing). Place the preprocessed ``wmt14.tgz`` in
``DATA_HOME/wmt14/``.
"""
from __future__ import annotations

from . import common

__all__ = []


def _dataset(mode, dict_size):
    from ..text.datasets import WMT14

    return WMT14(data_file=common.local_path("wmt14", "wmt14.tgz"),
                 mode=mode, dict_size=dict_size)


def _reader_creator(mode, dict_size):
    def reader():
        ds = _dataset(mode, dict_size)
        for sample in ds:
            yield tuple(sample)

    return reader


def train(dict_size):
    """Train reader creator: (src_ids, trg_ids, trg_ids_next)."""
    return _reader_creator("train", dict_size)


def test(dict_size):
    """Test reader creator."""
    return _reader_creator("test", dict_size)


def gen(dict_size):
    """Generation-split reader creator (the archive's ``gen`` file)."""
    return _reader_creator("gen", dict_size)


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict); ``reverse=True`` maps id→word."""
    ds = _dataset("train", dict_size)
    src, trg = ds.src_dict, ds.trg_dict
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def fetch():
    common.local_path("wmt14", "wmt14.tgz")
