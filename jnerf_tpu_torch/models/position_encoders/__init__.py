from .hash_encoder import HashEncoder  # noqa: F401
from .sh_encoder import SHEncoder  # noqa: F401
from .freq_encoder import FrequencyEncoder  # noqa: F401
