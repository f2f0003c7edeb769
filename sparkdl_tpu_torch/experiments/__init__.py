"""Measurement scripts of the port (``python -m
sparkdl_tpu_torch.experiments.<name>``); nothing here is on a user path."""
