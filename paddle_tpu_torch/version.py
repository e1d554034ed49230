"""The port's version (counterpart of the reference's ``version.py``)."""
__version__ = "0.1.0"
full_version = __version__
major, minor, patch = (int(p) for p in __version__.split("."))


def show() -> None:
    print(f"paddle_tpu_torch {__version__}")
