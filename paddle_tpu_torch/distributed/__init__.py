"""paddle.distributed analog for the port: so far only fleet's recompute."""
