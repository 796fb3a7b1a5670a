"""paddle.optimizer surface: counterpart of ``paddle_tpu/optimizer``
(reference: python/paddle/optimizer/__init__.py): every optimizer of the
reference, with Paddle's update rules rather than ``torch.optim``'s, and
the learning-rate schedulers of ``lr``."""
from .optimizer import Optimizer, L1Decay, L2Decay  # noqa: F401
from .optimizers import (SGD, Momentum, Adam, AdamW, Adamax, Adagrad, RMSProp,  # noqa: F401
                         Adadelta, Lamb, LBFGS, NAdam,
                         RAdam, Rprop, ASGD)
from . import lr  # noqa: F401
