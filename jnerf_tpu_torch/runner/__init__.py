from .runner import Runner  # noqa: F401
from .neus_runner import NeuSRunner  # noqa: F401
from .mip_runner import MipRunner  # noqa: F401
from .svox2_runner import Svox2Runner  # noqa: F401
