"""The plain fp32 references the benchmark judges the program's answers by,
one module per architecture: ``<architecture>_ref.py``, named by the
configuration's ``architecture`` key (``matbench/architecture.py``).  Each
imports ``torch`` alone, nothing of the program, and exposes:

* ``param_table(conf)``: (name, shape, kind) of every parameter it models,
  in a fixed order; kind is "w" (conv or linear weight), "b" (its bias), "nw"
  / "nb" (a norm's scale / shift).  ``weights.py`` draws the seeded weights
  of both sides from it;
* ``PIPELINE_KEYS``: the configuration's ``pipeline`` keys it models (a
  configuration with another is refused rather than judged against another
  path);
* ``stored(params, conf)``: the weights as the deployment holds them (its
  weight storage), worked out again from the fp32 ones;
* ``answer(params, conf, image, trimap, options)``: the whole call on one
  photo, image (H,W,3) and trimap (H,W) in [0, 1] fp32 on the weights'
  device, with the mix's ``options`` dict: (alpha (H,W), matted (H,W,C)) fp32;
* ``meta_forward(conf, options, height, width)``: the model's forward for
  one photo of that size at the mix's options, on the meta device: what
  ``harness.model_flops`` counts, over the sizes of the mix's pool.
"""

from __future__ import annotations

import torch


def exact_fp32() -> None:
    """No TF32 anywhere: float32 matmuls and convs in full precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
