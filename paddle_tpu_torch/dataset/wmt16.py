"""Legacy WMT16 en↔de readers (``paddle.dataset.wmt16``).

Reference: ``python/paddle/dataset/wmt16.py:104-340``. Delegates to
``paddle_tpu_torch.text.datasets.WMT16`` (train-split vocabularies with
<s>/<e>/<unk> first, then words by descending frequency, truncated to
the requested size; (src, trg, trg_next) samples). Place ``wmt16.tar.gz``
in ``DATA_HOME/wmt16/``.
"""
from __future__ import annotations

from . import common

__all__ = []


def _dataset(mode, src_dict_size, trg_dict_size, src_lang):
    from ..text.datasets import WMT16

    return WMT16(data_file=common.local_path("wmt16", "wmt16.tar.gz"),
                 mode=mode, src_dict_size=src_dict_size,
                 trg_dict_size=trg_dict_size, lang=src_lang)


def _reader_creator(mode, src_dict_size, trg_dict_size, src_lang):
    if src_lang not in ("en", "de"):
        raise ValueError("An error language type. Only support: en (for "
                         "English); de(for Germany).")

    def reader():
        ds = _dataset(mode, src_dict_size, trg_dict_size, src_lang)
        for sample in ds:
            yield tuple(sample)

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    """Train reader creator: (src_ids, trg_ids, trg_ids_next)."""
    return _reader_creator("train", src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    """Test reader creator."""
    return _reader_creator("test", src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    """Validation reader creator."""
    return _reader_creator("val", src_dict_size, trg_dict_size, src_lang)


def get_dict(lang, dict_size, reverse=False):
    """The vocabulary for ``lang`` ('en'|'de') at ``dict_size``;
    ``reverse=True`` maps id→word."""
    ds = _dataset("train",
                  dict_size if lang == "en" else -1,
                  dict_size if lang != "en" else -1, "en")
    d = ds.src_dict if lang == "en" else ds.trg_dict
    if reverse:
        d = {v: k for k, v in d.items()}
    return d


def fetch():
    common.local_path("wmt16", "wmt16.tar.gz")
