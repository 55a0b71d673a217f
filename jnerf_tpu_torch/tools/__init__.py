"""Command-line tools of the port, run as ``python3 -m jnerf_tpu_torch.tools.<name>``."""
