"""Checkpoint loader of the port: safetensors / ``.pth`` -> an ``SDMatte``
module, with the semantics of sdmatte_tpu/checkpoint/loader.py (and a
``ViTMatte`` module, whose names are transformers').

  * the weights stay in torch layout: the port's modules carry the
    checkpoint's key names and layouts, so each tensor is copied into the
    module's parameter of that name, in the parameter's dtype and on its
    device (no transposes)
  * legacy diffusers VAE attention aliases (query/key/value/proj_attn)
  * a wrapper prefix shared by every key is stripped (the flat-file analogue
    of the reference's nested-dict unwrapping); ``.pth`` files unwrap through
    the same candidate keys
  * strict=False: missing, unexpected and shape-mismatched keys are
    reported in a :class:`LoadReport`, and those parameters keep their
    values; known parameterless buffers are ignored
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn

from . import safetensors_io

# the reference's nested-checkpoint candidate keys
CANDIDATE_PREFIXES = [
    "state_dict.", "model_state_dict.", "params.", "weights.",
    "ema.", "model_ema.", "ema_state_dict.", "net.", "module.", "model.",
]
# the keys a .pth file is unwrapped through, in order
_PTH_KEYS = ("state_dict", "model_state_dict", "params", "weights", "ema",
             "model_ema", "ema_state_dict", "net", "module", "model", "unet")

# legacy diffusers VAE attention names -> modern ones
_VAE_ATTN_ALIASES = {
    "query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0",
}

# parameterless torch buffers that appear in some exports' state_dicts
# (older transformers registered position_ids as a persistent buffer); they
# carry no weights and must not count as "unexpected"
_IGNORED_BUFFER_SUFFIXES = ("position_ids", "num_batches_tracked")


@dataclasses.dataclass
class LoadReport:
    loaded: int = 0
    missing: List[str] = dataclasses.field(default_factory=list)      # in model, not in ckpt
    unexpected: List[str] = dataclasses.field(default_factory=list)   # in ckpt, not in model
    mismatched: List[Tuple[str, tuple, tuple]] = dataclasses.field(default_factory=list)
    ignored: List[str] = dataclasses.field(default_factory=list)      # known buffers

    def summary(self) -> str:
        return (f"loaded={self.loaded} missing={len(self.missing)} "
                f"unexpected={len(self.unexpected)} mismatched={len(self.mismatched)}")


def normalize_key(key: str) -> str:
    """The modern name of a legacy VAE attention key."""
    for old, new in _VAE_ATTN_ALIASES.items():
        key = key.replace(f".attentions.0.{old}.", f".attentions.0.{new}.")
    return key


def strip_wrapper_prefix(keys) -> str:
    """The candidate wrapper prefix that ALL keys share, or ''."""
    keys = list(keys)
    for pref in CANDIDATE_PREFIXES:
        if keys and all(k.startswith(pref) for k in keys):
            return pref
    return ""


@torch.no_grad()
def load_into_module(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> LoadReport:
    """Copy a flat torch state dict into ``model``'s parameters and
    buffers with strict=False semantics."""
    report = LoadReport()
    targets = model.state_dict(keep_vars=True)
    wrapper = strip_wrapper_prefix(tensors.keys())
    seen = set()
    for key, src in tensors.items():
        k = key[len(wrapper):]
        if k.endswith(_IGNORED_BUFFER_SUFFIXES):
            report.ignored.append(key)
            continue
        k = normalize_key(k)
        target = targets.get(k)
        if target is None:
            report.unexpected.append(key)
            continue
        if tuple(target.shape) != tuple(src.shape):
            report.mismatched.append((key, tuple(target.shape), tuple(src.shape)))
            continue
        target.copy_(src)
        report.loaded += 1
        seen.add(k)
    report.missing = [k for k in targets if k not in seen]
    return report


def read_torch_pickle(path: str) -> Dict[str, torch.Tensor]:
    """Legacy ``.pth`` checkpoints, loaded with ``weights_only=True`` and
    unwrapped through the reference's candidate keys."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for k in _PTH_KEYS:
            inner = obj.get(k)
            if isinstance(inner, dict):
                obj = inner
                break
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in obj.items()}


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith((".pth", ".pt", ".bin", ".ckpt")):
        return read_torch_pickle(path)
    return safetensors_io.read(path)


def load_sdmatte_checkpoint(model: nn.Module, ckpt_path: str) -> LoadReport:
    """Load SDMatte(.plus) weights (.safetensors or legacy .pth) into an
    ``SDMatte`` module in place."""
    return load_into_module(model, read_checkpoint(ckpt_path))


def load_vitmatte_checkpoint(model: nn.Module, ckpt_path: str) -> LoadReport:
    """Load a ``VitMatteForImageMatting`` checkpoint (transformers'
    ``model.safetensors``, or a ``.pth``) into a ``ViTMatte`` module in
    place: the port's names are transformers' own, so no key is mapped; the
    BatchNorm counters (``num_batches_tracked``), which hold no value at
    inference, are ignored."""
    return load_into_module(model, read_checkpoint(ckpt_path))
