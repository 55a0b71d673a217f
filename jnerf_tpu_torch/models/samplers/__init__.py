from .density_grid_sampler import DensityGridSampler  # noqa: F401
