"""paddle.distributed.fleet analog for the port."""
from .recompute import POLICIES, recompute, recompute_sequential  # noqa: F401
