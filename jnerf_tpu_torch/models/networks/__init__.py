from .ngp_network import NGPNetworks  # noqa: F401
