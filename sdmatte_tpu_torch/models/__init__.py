from . import vae, unet, clip, tokenizer, sdmatte  # noqa: F401
