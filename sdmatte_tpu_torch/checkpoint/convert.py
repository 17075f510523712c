"""Weights carried across from the JAX package's param tree.

``params_to_state_dict`` is the port's own copy of the layout rules of
sdmatte_tpu/checkpoint/toy.py::tree_to_torch_state_dict: a nested dict of
arrays whose paths are the checkpoint's key paths becomes a flat torch state
dict, with HWIO conv kernels as OIHW weights, (in, out) linear kernels as
(out, in) weights and norm ``scale``s as ``weight``s.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# top-level trees the port has no module for: the CLIP text tower never runs
# under the [T, T, T] gating the port supports (ROADMAP Queue 1 item 7)
UNPORTED_TREES = ("text_encoder",)


def params_to_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            arr = np.asarray(v, dtype=np.float32)
            name = ".".join(path)
            if k == "kernel" and arr.ndim == 4:
                arr, key = arr.transpose(3, 2, 0, 1), name + ".weight"
            elif k == "kernel" and arr.ndim == 2:
                arr, key = arr.transpose(1, 0), name + ".weight"
            elif k in ("scale", "embedding"):
                key = name + ".weight"
            else:
                key = name + "." + k
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, ())
    return out


def load_params(model: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX param tree into ``model`` with ``strict=True`` (the trees
    in ``UNPORTED_TREES`` are left out)."""
    sd = params_to_state_dict({k: v for k, v in tree.items() if k not in UNPORTED_TREES})
    model.load_state_dict(sd, strict=True)
    return model
