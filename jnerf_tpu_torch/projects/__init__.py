"""The mini-projects: pixelNeRF and Recursive-NeRF, each run as
``python -m jnerf_tpu_torch.projects.<name>.main``."""
