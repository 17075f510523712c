"""Fine-tune the matting model: the training stack end to end
(examples/finetune.py of the JAX package).

  * composite data with augmentation, prefetched one step ahead
  * warmup-cosine rate; L1 + uncertainty-band L1 + gradient L1 loss
  * the reference's tower freezing (only the U-Net trains); --train-all
    unfreezes the VAE and text towers
  * --remat: the U-Net's blocks recomputed on the backward pass
  * --ema-decay: an EMA of the weights; checkpoints; at the end an export of
    the EMA weights (the live ones without an EMA) as reference-layout
    safetensors

Smoke run on the CPU (fp32, the tiny config):
    python -m sdmatte_tpu_torch.finetune --tiny --cpu --steps 4 --out ft

Full width on one card (seeded random weights; the repo has no checkpoint):
    python -m sdmatte_tpu_torch.finetune --steps 200 --batch 4 --size 512 \
        --remat --ema-decay 0.999 --out ft_full

Several cards, data-parallel (each process its slice of --batch):
    torchrun --nproc_per_node 4 -m sdmatte_tpu_torch.finetune --mesh --batch 8 ...

It runs on the card unless --cpu, and exits with an error when it finds
none.  Training runs the plain versions of the kernel sites
(parallel/train.matting_loss enters ``ops/dispatch.implementation("plain")``):
no hand kernel has a backward.  The FP32 policy gets torch's precision
defaults, which this script does not change: cuDNN convs in TF32, cuBLAS
matmuls in full fp32; it prints both.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sdmatte_tpu_torch.finetune")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2, help="global batch size")
    ap.add_argument("--size", type=int, default=64,
                    help="composite/train resolution (multiple of 64)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny CI config instead of the full-size model")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--mesh", action="store_true",
                    help="data-parallel over the processes of the group "
                         "(run under torchrun)")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--train-all", action="store_true",
                    help="unfreeze the vae/text towers (the reference keeps them frozen)")
    ap.add_argument("--ema-decay", type=float, default=0.0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sdmatte_finetune"),
                    help="checkpoint/export directory")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from .configs import SDMatteConfig
    from .models.init import init_random_
    from .models.sdmatte import SDMatte
    from .parallel import checkpointing
    from .parallel import train as ptrain
    from .parallel.data import CompositeSampler
    from .parallel.mesh import distributed_init, make_mesh

    if not args.cpu and not torch.cuda.is_available():
        print("[finetune] CUDA is not available (pass --cpu to train on the CPU)",
              file=sys.stderr)
        return 2
    mesh = None
    if args.mesh:
        distributed_init(backend="gloo" if args.cpu else None)
        if not dist.is_initialized():
            print("[finetune] --mesh needs a process group: run under torchrun",
                  file=sys.stderr)
            return 2
        mesh = make_mesh()
    rank = dist.get_rank() if mesh is not None else 0
    device = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())

    cfg = SDMatteConfig.tiny() if args.tiny else SDMatteConfig()
    with torch.device("meta"):
        model = SDMatte(cfg)
    init_random_(model, seed=0, device=device)
    print(f"device={device} processes={dist.get_world_size() if mesh else 1} "
          f"mesh={'on' if mesh else 'off'} TF32: cuDNN convs "
          f"{torch.backends.cudnn.allow_tf32 and device.type == 'cuda'}, cuBLAS matmuls "
          f"{torch.backends.cuda.matmul.allow_tf32 and device.type == 'cuda'}", flush=True)

    result = ptrain.train_loop(
        model, steps=args.steps, batch_size=args.batch, mesh=mesh,
        sampler=CompositeSampler(size=args.size, seed=rank),
        learning_rate=ptrain.make_lr_schedule(
            args.lr, warmup_steps=max(2, args.steps // 10), total_steps=args.steps),
        loss_cfg=ptrain.LossConfig(l1=1.0, unknown_l1=1.0, grad_l1=0.5),
        frozen=() if args.train_all else ptrain.FROZEN_TOWERS,
        remat=args.remat, ema_decay=args.ema_decay,
        ckpt_dir=os.path.join(args.out, "ckpts"),
        ckpt_every=max(1, args.steps // 2), log_every=1)
    model, losses = result[0], result[1]
    ema = result[2] if args.ema_decay else None
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} steps", flush=True)

    if rank == 0:
        export = os.path.join(args.out, "finetuned.safetensors")
        checkpointing.export_reference_checkpoint(ema if ema is not None else model, export)
        kind = "EMA" if ema is not None else "live"
        print(f"exported {kind} weights (reference-compatible layout): {export}", flush=True)
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
