"""Boolean environment flags, parsed strictly (sdmatte_tpu/utils/env.py).

``FLAG=0`` / ``FLAG=false`` means OFF: plain ``bool(os.environ.get(...))``
treats the non-empty string ``"0"`` as True.
"""

import os

_TRUE = frozenset({"1", "true", "yes", "on"})
_FALSE = frozenset({"0", "false", "no", "off", ""})


def env_flag(name: str, default: bool = False) -> bool:
    """True/False for ``$name``; unset or unrecognized values -> default."""
    val = os.environ.get(name)
    if val is None:
        return default
    val = val.strip().lower()
    if val in _TRUE:
        return True
    if val in _FALSE:
        return False
    return default
