"""The matting fine-tune: loss, optimizer, data-parallel step and loop
(sdmatte_tpu/parallel/train.py).

L1 on the alpha, the uncertainty-band-weighted L1, a gradient L1 and an
optional feature-distillation term; AdamW with global-norm clipping over
the trained parameters only; an EMA of the weights; checkpoints.  The loss
runs the plain versions (:func:`matting_loss` enters
``ops/dispatch.implementation("plain")``), the counterpart of the JAX
package's ``attn_impl="xla"``: no hand kernel has a backward, in either
package (ops/_build.forward_only raises on one).

Data parallelism is the JAX package's SPMD step written out: each process
takes its slice of the global batch, the loss is the global batch's loss
(the unknown-band term's denominator is all-reduced first), and the
gradients are averaged over the processes before the optimizer runs, so the
step equals the one-process step on the whole batch.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as tF
from torch import nn

from ..core.dtypes import FP32, Policy
from ..ops.dispatch import implementation

# The reference freezes the VAE and the text tower and fine-tunes only the
# U-Net; frozen=() trains everything.  A frozen tower gets no gradient and no
# optimizer state.
FROZEN_TOWERS = ("vae", "text_encoder")


def uncertainty_weight(pred: torch.Tensor, width: int = 15) -> torch.Tensor:
    """The band of pixels whose alpha is neither ~0 nor ~1, dilated by a
    ``width`` max filter (the reference's cv2-dilated uncertainty band).

    pred (B, 1, H, W) in [0, 1] -> {0, 1} weights of the same shape.  The
    max-pool's implicit -inf padding is ``reduce_window``'s SAME."""
    eps = 1.0 / 255.0
    band = ((pred > eps) & (pred < 1.0 - eps)).float()
    k = 2 * (width // 2) + 1
    return tF.max_pool2d(band, k, stride=1, padding=k // 2)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Weights of the composite matting loss: plain L1, uncertainty-band L1,
    gradient L1 and feature distillation over the ``use_dis_loss`` maps."""
    l1: float = 1.0
    unknown_l1: float = 1.0
    grad_l1: float = 0.0
    dis: float = 0.0


def _grad_l1(pred, gt):
    """L1 on the spatial finite differences of (B, 1, H, W) maps."""
    dyp, dyg = pred[:, :, 1:] - pred[:, :, :-1], gt[:, :, 1:] - gt[:, :, :-1]
    dxp, dxg = pred[:, :, :, 1:] - pred[:, :, :, :-1], gt[:, :, :, 1:] - gt[:, :, :, :-1]
    return (dyp - dyg).abs().mean() + (dxp - dxg).abs().mean()


@contextlib.contextmanager
def _stop_gradient(model: nn.Module, towers: Sequence[str]):
    """The named towers record no gradient for what runs inside (the JAX
    package's stop_gradient); their flags are restored afterwards."""
    params = [p for name in towers if hasattr(model, name)
              for p in getattr(model, name).parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def _world(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def matting_loss(model: nn.Module, batch: dict, *, policy: Policy = FP32,
                 loss_cfg: LossConfig = LossConfig(), frozen: Sequence[str] = FROZEN_TOWERS,
                 remat: bool = False, group=None) -> torch.Tensor:
    """The composite loss of one batch (NCHW tensors: image, trimap,
    trimap_coords, is_trans, alpha_gt (B, 1, S, S), and teacher_features for
    the distillation term).

    The model runs on the plain versions.  ``frozen`` towers get no
    gradient.  ``remat`` rematerialises the U-Net's blocks.  Under
    ``cfg.use_dis_loss`` with ``teacher_features`` in the batch, adds the L2
    distance of the down/mid/up feature maps.

    ``group``: the process group of a data-parallel step, whose processes
    each hold an equal slice of the global batch.  The unknown-band term's
    denominator is then the global band's size, and the term is scaled so
    that the mean of the processes' losses is the global batch's loss (the
    mean terms need nothing: equal slices average to the global mean)."""
    with _stop_gradient(model, frozen), implementation("plain"):
        out = model(batch, policy=policy, remat=remat)
    pred, features = out if isinstance(out, tuple) else (out, None)
    gt = batch["alpha_gt"]
    l1 = (pred - gt).abs()
    loss = loss_cfg.l1 * l1.mean()
    if loss_cfg.unknown_l1:
        w = uncertainty_weight(gt)
        total = w.sum()
        term = loss_cfg.unknown_l1 * (l1 * w).sum()
        world = _world(group)
        if world > 1:
            dist.all_reduce(total, group=group)
            term = term * world
        loss = loss + term / torch.clamp(total, min=1.0)
    if loss_cfg.grad_l1:
        loss = loss + loss_cfg.grad_l1 * _grad_l1(pred, gt)
    if loss_cfg.dis and features is not None \
            and batch.get("teacher_features") is not None:
        for f, t in zip(features, batch["teacher_features"]):
            loss = loss + loss_cfg.dis * (f.float() - t.float()).square().mean()
    return loss


def make_lr_schedule(base_lr: float = 1e-5, *, warmup_steps: int = 100,
                     total_steps: int = 10_000, end_scale: float = 0.1
                     ) -> Callable[[int], float]:
    """Linear warmup from 0, then cosine decay to ``base_lr * end_scale``:
    ``optax.warmup_cosine_decay_schedule`` value for value, in its float32
    arithmetic (the cosine correctly rounded).  The rate of step 0 is 0."""
    f32 = torch.float32
    peak, end = base_lr, base_lr * end_scale
    decay = max(total_steps, warmup_steps + 1) - warmup_steps
    alpha = 0.0 if peak == 0.0 else end / peak

    def t(x):
        return torch.tensor(x, dtype=f32)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = t(1.0) - t(float(min(max(step, 0), warmup_steps))) / t(float(warmup_steps))
            return float(t(0.0 - peak) * frac + t(peak))
        c = t(float(min(step - warmup_steps, decay)))
        arg = t(math.pi) * c / t(float(decay))
        cos = t(0.5) * (t(1.0) + t(math.cos(float(arg))))
        return float(t(peak) * (t(1.0 - alpha) * cos + t(alpha)))

    return schedule


@dataclasses.dataclass
class TrainState:
    """The trained model, its optimizer and schedule, and the step count
    (the JAX package's (params, opt_state) pair; torch keeps both in
    place)."""
    model: nn.Module
    optimizer: torch.optim.AdamW
    learning_rate: Union[float, Callable[[int], float]]
    grad_clip: Optional[float]
    trained: list
    step: int = 0


def init_train_state(model: nn.Module, learning_rate=1e-5, *, weight_decay: float = 0.0,
                     grad_clip: Optional[float] = 1.0,
                     frozen: Sequence[str] = FROZEN_TOWERS) -> TrainState:
    """``learning_rate``: a float or a schedule (:func:`make_lr_schedule`).

    The ``frozen`` towers get ``requires_grad_(False)`` and stay out of the
    optimizer, so it holds no moments for them (optax's multi_transform with
    set_to_zero).  AdamW is optax's ``adamw``: decay decoupled and scaled by
    the rate, the same bias correction, ``weight_decay`` 0 unless given
    (torch's own default is 0.01).  Clipping scales the gradients by
    ``max_norm / norm`` when their global norm reaches ``grad_clip``, as
    ``optax.clip_by_global_norm`` does (torch's clip_grad_norm_ adds 1e-6)."""
    for name in frozen:
        if hasattr(model, name):
            getattr(model, name).requires_grad_(False)
    trained = [p for p in model.parameters() if p.requires_grad]
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    opt = torch.optim.AdamW(trained, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return TrainState(model, opt, learning_rate, grad_clip, trained)


def loss_and_grads(state: TrainState, batch: dict, **loss_kw):
    """The loss and each trained parameter's gradient (zeros for a trained
    parameter the forward does not reach, as JAX's gradient has), averaged
    over ``group`` when one is given; the gradients are left in ``.grad``.
    Returns the loss, all-reduced to the global batch's under a group."""
    group = loss_kw.get("group")
    state.optimizer.zero_grad(set_to_none=True)
    loss = matting_loss(state.model, batch, **loss_kw)
    loss.backward()
    for p in state.trained:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    world = _world(group)
    loss = loss.detach()
    if world > 1:
        tensors = [p.grad for p in state.trained] + [loss]
        for work in [dist.all_reduce(t, group=group, async_op=True) for t in tensors]:
            work.wait()
        torch._foreach_div_(tensors, world)
    return loss


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global norm reaches
    ``max_norm``, every gradient becomes ``(g / norm) * max_norm``.  Returns
    the norm."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    if bool(norm >= max_norm):
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


def apply_gradients(state: TrainState) -> None:
    """The update from the gradients in ``.grad``, in place: clipping, the
    scheduled rate of this step, AdamW (optax's ``tx.update`` and
    ``apply_updates``)."""
    if state.grad_clip:
        clip_by_global_norm_([p.grad for p in state.trained], state.grad_clip)
    lr = state.learning_rate
    for g in state.optimizer.param_groups:
        g["lr"] = lr(state.step) if callable(lr) else lr
    state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, batch: dict, *, policy: Policy = FP32,
               loss_cfg: LossConfig = LossConfig(), frozen: Sequence[str] = FROZEN_TOWERS,
               remat: bool = False, group=None) -> torch.Tensor:
    """One step in place: loss and gradients (averaged over ``group``), then
    :func:`apply_gradients`.  Returns the loss."""
    loss = loss_and_grads(state, batch, policy=policy, loss_cfg=loss_cfg,
                          frozen=frozen, remat=remat, group=group)
    apply_gradients(state)
    return loss


def make_sharded_train_step(mesh, **step_kw) -> Callable:
    """:func:`train_step` over the mesh's data axes: each process passes its
    own slice of the global batch (``parallel.mesh.shard_batch``, or what
    ``prefetch_batches`` gives it), and every process ends the step with the
    same parameters, which must be equal before it (``parallel.mesh.replicate``)."""
    from .mesh import data_group
    return functools.partial(train_step, group=data_group(mesh), **step_kw)


def ema_update_(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """``ema = decay * ema + (1 - decay) * model`` over every parameter."""
    e = [p.detach() for p in ema.parameters()]
    m = [p.detach() for p in model.parameters()]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, m, alpha=1.0 - decay)


def train_loop(model: nn.Module, *, steps: int, batch_size: int, mesh=None,
               sampler=None, learning_rate=1e-4, loss_cfg: LossConfig = LossConfig(),
               policy: Policy = FP32, frozen: Sequence[str] = FROZEN_TOWERS,
               remat: bool = False, ema_decay: float = 0.0, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 0, log_every: int = 10):
    """Fine-tune ``model`` in place on the device it lives on: prefetched
    composite batches -> (data-parallel) steps -> checkpoints.

    Returns (model, losses), or (model, losses, ema) when ``ema_decay`` > 0,
    where ``ema`` is a copy of the model holding the exponential moving
    average of every parameter.  Losses are kept every ``log_every`` steps
    and at the last one.  Rank 0 writes a checkpoint every ``ckpt_every``
    steps (parallel/checkpointing.py)."""
    from ..utils.observability import get_logger
    from . import checkpointing
    from .data import CompositeSampler, prefetch_batches
    log = get_logger("sdmatte_tpu_torch.train")
    rank = dist.get_rank() if mesh is not None else 0
    device = next(model.parameters()).device

    # processes draw distinct data: each composites its own slice
    sampler = sampler or CompositeSampler(size=64, seed=rank)
    state = init_train_state(model, learning_rate, frozen=frozen)
    step_kw = dict(policy=policy, loss_cfg=loss_cfg, frozen=frozen, remat=remat)
    if mesh is not None:
        from .mesh import replicate
        replicate(model, mesh)
        step_fn = make_sharded_train_step(mesh, **step_kw)
    else:
        step_fn = functools.partial(train_step, **step_kw)
    ema = None
    if ema_decay:
        ema = copy.deepcopy(model).requires_grad_(False)

    losses = []
    for i, batch in enumerate(prefetch_batches(sampler, batch_size, steps=steps,
                                               mesh=mesh, device=device)):
        loss = step_fn(state, batch)
        if ema is not None:
            ema_update_(ema, model, ema_decay)
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
            log.info("step %d loss %.5f", i, losses[-1])
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            if rank == 0:
                checkpointing.save_train_state(ckpt_dir, i + 1, state, ema=ema)
            if mesh is not None:
                dist.barrier()
    if ema is not None:
        return model, losses, ema
    return model, losses
