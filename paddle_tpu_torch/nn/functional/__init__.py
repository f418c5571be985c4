"""paddle.nn.functional analog for the port."""
from .activation import swiglu  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401
