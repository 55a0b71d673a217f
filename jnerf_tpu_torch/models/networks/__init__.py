from .ngp_network import NGPNetworks  # noqa: F401
from .ori_nerf_network import OriginNeRFNetworks  # noqa: F401
from .neus_network import NeuS  # noqa: F401
from .mip_network import MipNerfMLP  # noqa: F401
from .svox2_network import SparseGrid  # noqa: F401
