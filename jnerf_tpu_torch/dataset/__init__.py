from .procedural import SyntheticSpheresDataset  # noqa: F401
