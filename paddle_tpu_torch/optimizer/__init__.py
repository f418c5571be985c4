"""paddle.optimizer analog for the port: the optimizers, schedulers and
clips the Llama training step needs."""
from . import lr  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
