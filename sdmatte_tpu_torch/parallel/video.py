"""Video matting: the clip's frames as one batch, the per-clip conditioning
made once (sdmatte_tpu/parallel/video.py).

Frames are independent through the single-pass model, so a clip is one
forward at batch T with the prompt's coordinates and the opacity tiled over
the frames (the split encode takes T > 8, as for any batch).  With a mesh,
each process mattes its own T / world frames and the alphas are gathered in
frame order: no collective runs inside the model.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.dtypes import FP32, Policy


@torch.no_grad()
def matte_video(model, frames: torch.Tensor, trimaps: torch.Tensor, *, mesh=None,
                is_transparent: bool = False, policy: Policy = FP32) -> torch.Tensor:
    """frames (T, 3, S, S) and trimaps (T, 1, S, S) in [-1, 1] -> alpha
    (T, 1, S, S) fp32 in [0, 1], on the model's device.  ``model`` holds its
    weights in the policy's parameter dtype (ops/quant.stage_, as the
    pipeline stages them)."""
    t = frames.shape[0]
    dev = next(model.parameters()).device
    rank_frames = slice(0, t)
    if mesh is not None:
        from .mesh import data_spec
        rank_frames = data_spec(mesh, t)
    cd = policy.compute_dtype
    image = frames[rank_frames].to(dev, cd)
    n = image.shape[0]
    data = {
        "image": image,
        "trimap": trimaps[rank_frames].to(dev, cd),
        # per-clip conditioning: the same prompt for every frame
        "trimap_coords": torch.tensor([[0.0, 0.0, 1.0, 1.0]], device=dev).expand(n, 4),
        "is_trans": torch.full((n,), 1.0 if is_transparent else 0.0, device=dev),
    }
    alpha = model(data, aux_input_type="trimap", policy=policy)
    if isinstance(alpha, tuple):    # cfg.use_dis_loss: (alpha, feature_maps)
        alpha = alpha[0]
    alpha = alpha.float().contiguous()
    if mesh is None or mesh.size() == 1:
        return alpha
    from .mesh import data_group
    parts = [torch.empty_like(alpha) for _ in range(mesh.size())]
    dist.all_gather(parts, alpha, group=data_group(mesh))
    return torch.cat(parts)
