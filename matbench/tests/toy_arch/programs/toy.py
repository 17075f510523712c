"""The toy architecture's program: two 3x3 convs from photo || trimap to
alpha at the photo's own resolution, in plain torch, behind the pipeline
contract of ``matbench/program.py``."""

from __future__ import annotations

import torch

# the program's own lower-precision path: the net in bfloat16
CONTROL = {"half": True}


class Net(torch.nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(4, width, 3, padding=1)
        self.conv2 = torch.nn.Conv2d(width, 1, 3, padding=1)

    def forward(self, x):
        return torch.sigmoid(self.conv2(torch.relu(self.conv1(x))))


class Pipeline:
    def __init__(self, model, device, half: bool = False):
        self.dtype = torch.bfloat16 if half else torch.float32
        self.model = model.to(device=device, dtype=self.dtype)
        self.device = device

    @torch.no_grad()
    def __call__(self, image, trimap, options=None):
        x, image = self._pre(image, trimap)
        return self._post(self._heavy(x), image)

    def _pre(self, image, trimap):
        image = torch.as_tensor(image, dtype=torch.float32)
        trimap = torch.as_tensor(trimap, dtype=torch.float32)
        if image.ndim == 3:
            image, trimap = image[None], trimap[None]
        x = torch.cat([image.permute(0, 3, 1, 2), trimap[:, None]], dim=1)
        return x.to(self.device, self.dtype), image

    def _heavy(self, x):
        return self.model(x)[:, 0].float()

    def _post(self, alpha, image):
        alpha = alpha.cpu()
        return alpha, image * alpha[..., None]


def declare(conf: dict):
    return Net(conf["width"])


def program_only_shapes(model) -> dict:
    return {}


def param_dtype(conf: dict):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[conf["precision"]["params"]]


def pipeline(model, conf: dict, device, **keywords):
    return Pipeline(model, device, **keywords)


def options(mix: dict):
    return dict(mix["options"])
