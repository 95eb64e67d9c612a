"""Runnable entry points of the port (``python -m
paddle_tpu_torch.examples.<name>``)."""
