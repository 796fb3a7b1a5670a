"""paddle.nn layers: counterpart of ``paddle_tpu/nn/layer/__init__.py``,
less the modules the port does not have yet (``rnn``, ``extras``)."""
from .layers import Layer  # noqa: F401
from .common import *  # noqa: F401,F403
from .container import Sequential, LayerList, ParameterList, LayerDict  # noqa: F401
from .activation import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .transformer import (MultiHeadAttention, Transformer, TransformerEncoder,  # noqa: F401
                          TransformerEncoderLayer, TransformerDecoder,
                          TransformerDecoderLayer)
