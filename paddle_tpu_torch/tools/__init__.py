"""Measurement scripts run on the card (``python -m
paddle_tpu_torch.tools.<name>``); nothing in the package imports them."""
