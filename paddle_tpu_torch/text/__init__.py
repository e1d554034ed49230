"""``paddle_tpu_torch.text``: text datasets and native tokenization
(counterpart of the reference's ``text/``).

The dataset classes read the standard corpora from files already on disk
(paddle's ``python/paddle/text/`` formats); the tokenizer is a C++ core
(``fast_tokenizer.cpp``, built by ``g++`` at first use, loaded through
ctypes) with a Python twin.
"""
from .datasets import (  # noqa: F401
    Conll05st,
    Imdb,
    Imikolov,
    Movielens,
    UCIHousing,
    WMT14,
    WMT16,
)
from .tokenizer import (  # noqa: F401
    WordpieceTokenizer,
    load_vocab,
    native_available,
)

__all__ = ["Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing", "WMT14", "WMT16",
           "WordpieceTokenizer", "load_vocab", "native_available"]
