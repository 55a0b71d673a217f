from .density_grid_sampler import DensityGridSampler  # noqa: F401
from .neus_renderer import NeuSRenderer  # noqa: F401
