"""Weights carried across from the JAX package's param tree.

``params_to_state_dict`` is the port's own copy of the layout rules of
sdmatte_tpu/checkpoint/toy.py::tree_to_torch_state_dict: a nested dict of
arrays whose paths are the checkpoint's key paths becomes a flat torch state
dict, with HWIO conv kernels as OIHW weights, (in, out) linear kernels as
(out, in) weights and norm ``scale``s as ``weight``s.

A tree that the JAX package has already quantized (sdmatte_tpu/ops/quant.py)
carries across as it is: int8 compute fields ``kernel_q`` / ``kernel_scale``
become ``weight_q`` / ``weight_scale`` and int8 storage ``kernel_i8`` /
``kernel_s`` becomes ``weight_i8`` / ``weight_s``, in the same layouts, with
the int8 values kept as int8 and the scales as fp32; :func:`load_params`
gives the modules those buffers, so nothing is quantized again.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..ops.quant import SCALE_NAMES

# top-level trees the port has no module for: the CLIP text tower never runs
# under the [T, T, T] gating the port supports (ROADMAP Queue 1: "Text tower")
UNPORTED_TREES = ("text_encoder",)
# JAX leaf name -> torch name, for the leaves laid out as kernels
_KERNELS = {"kernel": "weight", "kernel_q": "weight_q", "kernel_i8": "weight_i8"}
_SCALES = {"kernel_scale": "weight_scale", "kernel_s": "weight_s"}


def params_to_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            arr = np.asarray(v)
            arr = arr if arr.dtype == np.int8 else arr.astype(np.float32)
            name = ".".join(path)
            if k in _KERNELS and arr.ndim == 4:
                arr, key = arr.transpose(3, 2, 0, 1), f"{name}.{_KERNELS[k]}"
            elif k in _KERNELS and arr.ndim == 2:
                arr, key = arr.transpose(1, 0), f"{name}.{_KERNELS[k]}"
            elif k in _SCALES:
                key = f"{name}.{_SCALES[k]}"
            elif k in ("scale", "embedding"):
                key = name + ".weight"
            else:
                key = name + "." + k
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, ())
    return out


def _adopt_int8_fields(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Give each layer the int8 buffers its entries in ``sd`` carry; int8
    storage replaces the layer's fp weight."""
    for key, t in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf not in ("weight_q", "weight_i8") + SCALE_NAMES:
            continue
        m = model.get_submodule(prefix)
        if leaf == "weight_i8" and "weight" in m._parameters:
            del m.weight
        m.register_buffer(leaf, torch.empty_like(
            t, memory_format=torch.channels_last if t.ndim == 4 else torch.preserve_format))


def load_params(model: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX param tree into ``model`` with ``strict=True`` (the trees
    in ``UNPORTED_TREES`` are left out)."""
    sd = params_to_state_dict({k: v for k, v in tree.items() if k not in UNPORTED_TREES})
    _adopt_int8_fields(model, sd)
    model.load_state_dict(sd, strict=True)
    return model
