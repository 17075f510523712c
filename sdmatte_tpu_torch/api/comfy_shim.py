"""ComfyUI host shims (sdmatte_tpu/api/comfy_shim.py): the real
``folder_paths`` / ``comfy`` inside ComfyUI, else a standalone registry so the
node, the CLI and the server work anywhere.
"""

from __future__ import annotations

import os
from typing import Dict, List

try:  # inside ComfyUI
    import folder_paths as _fp  # type: ignore
    HAVE_COMFY = True
except ImportError:
    _fp = None
    HAVE_COMFY = False


def _model_management():
    """Host device manager, resolved at each call, so a ComfyUI host that
    finishes its own imports after loading custom nodes is still seen."""
    try:
        from comfy import model_management  # type: ignore
        return model_management
    except ImportError:
        return None


class _StandaloneRegistry:
    def __init__(self):
        root = os.environ.get("SDMATTE_TPU_MODELS_DIR",
                              os.path.join(os.path.expanduser("~"), ".cache",
                                           "sdmatte_tpu", "models"))
        self.models_dir = root
        self._paths: Dict[str, List[str]] = {}

    def add_model_folder_path(self, kind: str, path: str):
        self._paths.setdefault(kind, [])
        if path not in self._paths[kind]:
            self._paths[kind].append(path)

    def get_folder_paths(self, kind: str) -> List[str]:
        return list(self._paths.get(kind, []))


_registry = _StandaloneRegistry()


def models_dir() -> str:
    return _fp.models_dir if HAVE_COMFY else _registry.models_dir


def add_model_folder_path(kind: str, path: str):
    (_fp if HAVE_COMFY else _registry).add_model_folder_path(kind, path)


def get_folder_paths(kind: str) -> List[str]:
    try:
        return (_fp if HAVE_COMFY else _registry).get_folder_paths(kind) or []
    except Exception:
        return []


def host_prefers_cpu() -> bool:
    """True when a ComfyUI host is present and its device manager resolves
    compute to the CPU (a ``--cpu`` launch, no card), as the reference asks
    ``comfy.model_management.get_torch_device()`` per call.  The port's
    compute is torch, so the host's torch device is the signal itself (the
    JAX package also asks whether JAX has an accelerator, because torch
    cannot see a TPU).  An explicit ``force_cpu=True`` on the node remains
    the unconditional override.  Standalone (no ComfyUI): always False.
    """
    mm = _model_management()
    if mm is None:
        return False
    try:
        return getattr(mm.get_torch_device(), "type", None) == "cpu"
    except Exception:
        return False


def soft_empty_cache() -> None:
    """Release the host's torch device caches after a matte through the
    host's own policy hook (the reference's post-run
    ``torch.cuda.empty_cache()``).  No-op standalone."""
    mm = _model_management()
    if mm is None:
        return
    try:
        mm.soft_empty_cache()
    except Exception:
        pass


def register_default_dirs():
    d = os.path.join(models_dir(), "SDMatte")
    add_model_folder_path("SDMatte", d)
    return d
