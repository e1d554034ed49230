"""Legacy ``paddle.dataset`` namespace (deprecated in the reference since
2.0 in favor of ``paddle.vision.datasets`` / ``paddle.text.datasets``,
kept for API parity; reference ``python/paddle/dataset/__init__.py``).

Zero-egress build: nothing downloads. Each module documents the
conventional path under ``common.DATA_HOME`` where its standard archive
must be placed; most modules delegate parsing to the modern dataset
classes in ``paddle_tpu_torch.vision``/``paddle_tpu_torch.text``.
"""
from . import (  # noqa: F401
    cifar,
    common,
    conll05,
    flowers,
    image,
    imdb,
    imikolov,
    mnist,
    movielens,
    uci_housing,
    voc2012,
    wmt14,
    wmt16,
)

__all__ = [
    "mnist", "imikolov", "imdb", "cifar", "movielens", "conll05",
    "uci_housing", "wmt14", "wmt16", "flowers", "voc2012", "image",
    "common",
]
