from . import imaging, embeddings, dtypes, nn  # noqa: F401
