"""Training checkpoints and resume, and export of trained weights
(sdmatte_tpu/parallel/checkpointing.py, which writes with orbax).

One ``torch.save`` file per step, ``<ckpt_dir>/step_%08d``, holding the
step, the model's state dict, the optimizer's and, when there is one, the
EMA's.  A file is written under a temporary name and renamed into place, so
a reader never sees half a checkpoint.  :func:`export_reference_checkpoint`
writes the weights as torch-layout safetensors that the reference loads.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
from torch import nn

_PREFIX = "step_"


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{_PREFIX}{step:08d}")


def save_train_state(ckpt_dir: str, step: int, state, *, ema: Optional[nn.Module] = None) -> str:
    """Write ``state`` (train.TrainState: its model and optimizer) and the
    optional ``ema`` model as the checkpoint of ``step``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    blob = {"step": step, "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}
    if ema is not None:
        blob["ema"] = ema.state_dict()
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.{os.getpid()}.tmp")
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d[len(_PREFIX):]) for d in os.listdir(ckpt_dir)
             if d.startswith(_PREFIX) and d[len(_PREFIX):].isdigit()]
    return max(steps) if steps else None


def restore_train_state(ckpt_dir: str, *, step: Optional[int] = None,
                        with_ema: bool = False) -> Tuple:
    """(step, model state dict, optimizer state dict) of ``step``, the latest
    by default, on the CPU; ``with_ema`` appends the EMA's state dict, or
    None when the checkpoint has none.  Load them with ``load_state_dict``."""
    s = step if step is not None else latest_step(ckpt_dir)
    if s is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    blob = torch.load(_path(ckpt_dir, s), map_location="cpu", weights_only=True)
    out = (blob["step"], blob["model"], blob["optimizer"])
    return out + (blob.get("ema"),) if with_ema else out


def export_reference_checkpoint(model: nn.Module, path: str) -> int:
    """``model``'s weights as reference-layout safetensors, written by the
    port's own writer (checkpoint/toy.save_checkpoint); returns the size."""
    from ..checkpoint.toy import save_checkpoint
    return save_checkpoint(model, path)
