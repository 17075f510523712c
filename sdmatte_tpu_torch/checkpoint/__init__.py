from .loader import (  # noqa: F401
    CANDIDATE_PREFIXES, LoadReport, load_into_module, load_sdmatte_checkpoint,
    load_vitmatte_checkpoint,
    read_checkpoint, read_torch_pickle,
)
from .toy import save_checkpoint  # noqa: F401
