"""paddle.jit analog for the port: the eager training step."""
from .api import TrainStep  # noqa: F401
