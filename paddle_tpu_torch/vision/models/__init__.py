"""``paddle_tpu_torch.vision.models`` (counterpart of the reference's
``vision/models/``): LeNet, the ResNet family, VGG, the MobileNets (V1,
V2, V3 Small and Large), AlexNet, SqueezeNet, ShuffleNetV2, DenseNet,
GoogLeNet and InceptionV3.  Each constructor takes ``device=None``
(``cuda``; raises without a card) and ``seed=0``, the seed of the
``torch.Generator`` its weights are drawn from; ``pretrained=True``
raises.  Parameter and buffer names are the reference's, so
``load_reference_params`` carries a reference model across."""
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (DenseNet, densenet121, densenet161,  # noqa: F401
                       densenet169, densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,  # noqa: F401
                          mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152, wide_resnet50_2,
                     wide_resnet101_2)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_x0_5,  # noqa: F401
                           shufflenet_v2_x0_25, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

__all__ = [
    "LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "wide_resnet50_2", "wide_resnet101_2", "VGG", "vgg11",
    "vgg13", "vgg16", "vgg19", "MobileNetV2", "mobilenet_v2", "MobileNetV1",
    "mobilenet_v1", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v3_small", "mobilenet_v3_large", "AlexNet", "alexnet",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "DenseNet",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
]
