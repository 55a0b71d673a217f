from .density_grid_sampler import DensityGridSampler  # noqa: F401
from .neus_renderer import NeuSRenderer  # noqa: F401
from .mip_sampler import MipSampler  # noqa: F401
