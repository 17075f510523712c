from .attention import attention  # noqa: F401
