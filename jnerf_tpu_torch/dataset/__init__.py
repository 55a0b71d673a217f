from .dataset import NerfDataset  # noqa: F401
from .llff_dataset import LLFFDataset  # noqa: F401
from .procedural import SyntheticSpheresDataset  # noqa: F401
from .neus_dataset import NeuSDataset  # noqa: F401
from .mip_dataset import Blender, Blenders, Multicam  # noqa: F401
from .svox_dataset import SvoxNeRFDataset  # noqa: F401
