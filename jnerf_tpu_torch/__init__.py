"""jnerf_tpu_torch: the PyTorch + CUDA port of jnerf_tpu.

Module paths and names follow the JAX package (`jnerf_tpu/`), which stays
the reference the port is tested against.  This package imports torch and
never jax.  Importing it registers the built-in components.
"""

__version__ = "0.1.0"

from jnerf_tpu_torch.utils.config import get_cfg, init_cfg, save_cfg, update_cfg  # noqa: F401
from jnerf_tpu_torch.utils.registry import (  # noqa: F401
    DATASETS, ENCODERS, LOSSES, NETWORKS, OPTIMS, SAMPLERS, SCHEDULERS,
    build_from_cfg,
)

# Importing subpackages registers all built-in components.
from jnerf_tpu_torch import dataset, models, optims  # noqa: F401
