"""paddle_tpu_torch.analysis: the runtime lock-order watchdog (counterpart:
``paddle_tpu/analysis/lock_watchdog.py``)."""
