from .runner import Runner  # noqa: F401
from .neus_runner import NeuSRunner  # noqa: F401
