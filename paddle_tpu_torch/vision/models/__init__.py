"""``paddle_tpu_torch.vision.models`` (counterpart of the reference's
``vision/models/``): ``LeNet`` and the ResNet family.  Each constructor
takes ``device=None`` (``cuda``; raises without a card) and ``seed=0``,
the seed of the ``torch.Generator`` its weights are drawn from."""
from .lenet import LeNet  # noqa: F401
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152, wide_resnet50_2,
                     wide_resnet101_2)

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2"]
