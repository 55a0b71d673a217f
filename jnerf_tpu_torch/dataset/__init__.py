from .dataset import NerfDataset  # noqa: F401
from .llff_dataset import LLFFDataset  # noqa: F401
from .procedural import SyntheticSpheresDataset  # noqa: F401
