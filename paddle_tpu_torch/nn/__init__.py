"""Layers and functionals of the port (counterpart of ``paddle_tpu.nn``).

A layer is a ``torch.nn.Module`` with the reference's constructor,
parameter names and shapes; a layer with parameters takes ``device=``
(and, where it draws them, ``generator=``), built on torch's default
device when none is given.  ``ParamAttr`` and ``initializer`` configure
parameters as in the reference (``layer.layers``).  The sequence models'
parts: the encoder-decoder ``Transformer`` and its layers with their
attention caches, the recurrent cells and stacks (``layer.rnn``), and
beam search (``BeamSearchDecoder``, ``dynamic_decode``)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import lora  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer.activation import (ELU, GELU, GLU, Hardshrink,  # noqa: F401
                               Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                               LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                               ReLU, ReLU6, SELU, Sigmoid, Silu, Softmax,
                               Softplus, Softshrink, Softsign, Swish, Tanh,
                               Tanhshrink, ThresholdedReLU)
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.container import (LayerDict, LayerList,  # noqa: F401
                              ParameterList, Sequential)
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                         Conv2DTranspose, Conv3D, Conv3DTranspose)
from .layer.layers import ParamAttr, create_parameter  # noqa: F401
from .layer.loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                         CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss,
                         HSigmoidLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                         MSELoss, NLLLoss, SmoothL1Loss)
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                         BatchNorm3D, LayerNorm)
from .layer.pooling import (AdaptiveAvgPool1D,  # noqa: F401
                            AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                            AdaptiveMaxPool1D, AdaptiveMaxPool2D,
                            AdaptiveMaxPool3D, AvgPool1D, AvgPool2D,
                            AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell,  # noqa: F401
                        LSTMCell, RNNCellBase, SimpleRNN, SimpleRNNCell)
from .layer.transformer import (MultiHeadAttention,  # noqa: F401
                                Transformer, TransformerDecoder,
                                TransformerDecoderLayer, TransformerEncoder,
                                TransformerEncoderLayer)
from .ssm import GatedSSMBlock, RecurrentDecodeCache, SSMLM  # noqa: F401
