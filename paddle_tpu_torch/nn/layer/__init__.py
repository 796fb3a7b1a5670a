"""paddle.nn layers: counterpart of ``paddle_tpu/nn/layer/__init__.py``."""
from .layers import Layer  # noqa: F401
from .common import *  # noqa: F401,F403
from .container import Sequential, LayerList, ParameterList, LayerDict  # noqa: F401
from .activation import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .rnn import (SimpleRNNCell, LSTMCell, GRUCell, RNN, BiRNN, SimpleRNN,  # noqa: F401
                  LSTM, GRU)
from .transformer import (MultiHeadAttention, Transformer, TransformerEncoder,  # noqa: F401
                          TransformerEncoderLayer, TransformerDecoder,
                          TransformerDecoderLayer)
from .extras import (PoissonNLLLoss, GaussianNLLLoss, SoftMarginLoss,  # noqa: F401
                     MultiLabelSoftMarginLoss, MultiMarginLoss,
                     TripletMarginWithDistanceLoss, CTCLoss, RNNTLoss,
                     HSigmoidLoss, AdaptiveLogSoftmaxWithLoss, Softmax2D,
                     Unflatten, ParameterDict, ZeroPad1D, ZeroPad3D,
                     LPPool1D, LPPool2D, FractionalMaxPool2D,
                     FractionalMaxPool3D, MaxUnPool3D, BeamSearchDecoder,
                     dynamic_decode)
from .rnn import RNNCellBase  # noqa: F401
