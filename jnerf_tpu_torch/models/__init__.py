from . import losses, networks, position_encoders, samplers  # noqa: F401
