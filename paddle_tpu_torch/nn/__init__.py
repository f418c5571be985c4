"""paddle.nn analog for the port: the layers Llama needs, and weight-only
quantized serving (``nn.quant``)."""
from . import functional  # noqa: F401
from . import quant  # noqa: F401
from .layer.common import Embedding, Linear  # noqa: F401
from .layer.norm import RMSNorm  # noqa: F401
