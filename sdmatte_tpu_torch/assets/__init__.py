from .manager import (  # noqa: F401
    MODEL_URLS, SD21_CONFIG_MANIFEST, download_model, ensure_sd21_configs,
    resolve_model, AssetError,
)
