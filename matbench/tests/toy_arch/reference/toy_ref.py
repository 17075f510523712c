"""Plain reference of the toy architecture (``torch`` alone): two 3x3 convs
from photo || trimap to alpha, written apart from its program."""

from __future__ import annotations

import torch
import torch.nn.functional as F

PIPELINE_KEYS = frozenset()


def param_table(conf: dict) -> list[tuple[str, tuple, str]]:
    w = conf["width"]
    return [("conv1.weight", (w, 4, 3, 3), "w"), ("conv1.bias", (w,), "b"),
            ("conv2.weight", (1, w, 3, 3), "w"), ("conv2.bias", (1,), "b")]


def stored(params: dict, conf: dict) -> dict:
    return params


def forward(P, x):
    h = torch.relu(F.conv2d(x, P["conv1.weight"], P["conv1.bias"], padding=1))
    return torch.sigmoid(F.conv2d(h, P["conv2.weight"], P["conv2.bias"], padding=1))


def answer(P, conf, image, trimap, options: dict):
    x = torch.cat([image.permute(2, 0, 1), trimap[None]], dim=0)[None]
    alpha = forward(P, x)[0, 0].float()
    return alpha, image * alpha[..., None]


def meta_forward(conf, options: dict, height: int, width: int):
    """At the photo's own size, as the toy runs."""
    meta = torch.device("meta")
    P = {n: torch.empty(s, device=meta) for n, s, _ in param_table(conf)}
    return forward(P, torch.empty((1, 4, height, width), device=meta))
