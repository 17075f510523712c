from .attention import relpos_terms  # noqa: F401  (loaded first, so the name below stays)
from .flash_attention import flash_attention as attention  # noqa: F401  (the JAX package's name)
