"""Standalone CLI of the port: image + trimap -> alpha / matted PNG, no
ComfyUI needed (sdmatte_tpu/cli.py).

Usage:
    python -m sdmatte_tpu_torch.cli --image in.png --trimap tri.png --out alpha.png \
        [--ckpt SDMatte.safetensors] [--size 1024] [--mode alpha_only]
        [--refine/--no-refine] [--tc 0.8] [--cpu] [--random-weights]

It runs bf16 on the CUDA card; ``--cpu`` runs fp32 on the CPU, and without
``--cpu`` and without CUDA it exits with an error.

Directory mode batches a folder: same-shape pairs are stacked up to
``--batch`` per pipeline call.  PyTorch runs eagerly and compiles nothing
per batch size, so a short last chunk runs as it is (the JAX CLI pads it to
a batch size it has already compiled):

    python -m sdmatte_tpu_torch.cli --image imgs/ --trimap tris/ --out alphas/ \
        [--matted-out matted/] [--batch 8]

Images and trimaps pair by filename stem (imgs/cat.png <-> tris/cat.png).

``--random-weights`` builds the model from seeded random weights instead of
a checkpoint; ``--tiny`` additionally shrinks it to the CI config.

``--model vitmatte`` runs ViTMatte (hustvl/ViTMatte, ``ViTMatteConfig``'s
defaults are ViTMatte-B's) at the photo's own resolution, padded to 32:
``--ckpt`` is then a transformers ``VitMatteForImageMatting`` checkpoint
(``model.safetensors``), ``--size``, ``--prompt-type``, ``--coords``
and ``--speed-mode`` do not apply, and ``--transparent`` is accepted and
ignored (ViTMatte has no opacity input):

    python -m sdmatte_tpu_torch.cli --model vitmatte --image in.png --trimap tri.png \
        --out alpha.png (--ckpt model.safetensors | --random-weights)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .utils.images import load_unit_image, save_png

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _pair_directory(image_dir: str, trimap_dir: str):
    """Pair image/trimap files by stem. Returns [(stem, img_path, tri_path)]."""
    tris = {}
    for f in sorted(os.listdir(trimap_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in _IMAGE_EXTS:
            tris.setdefault(stem, os.path.join(trimap_dir, f))
    pairs, missing, dup = [], [], []
    seen = set()
    for f in sorted(os.listdir(image_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() not in _IMAGE_EXTS:
            continue
        if stem in seen:
            # cat.png + cat.jpg would both write out/<stem>.png: keep the
            # first (sorted order) instead of silently overwriting results
            dup.append(f)
            continue
        seen.add(stem)
        if stem in tris:
            pairs.append((stem, os.path.join(image_dir, f), tris[stem]))
        else:
            missing.append(f)
    if dup:
        print(f"[cli] skipping {len(dup)} image(s) whose stem collides with "
              f"an earlier file (outputs are named <stem>.png): "
              f"{', '.join(dup[:5])}{' ...' if len(dup) > 5 else ''}",
              file=sys.stderr)
    if missing:
        print(f"[cli] skipping {len(missing)} image(s) without a matching "
              f"trimap: {', '.join(missing[:5])}"
              f"{' ...' if len(missing) > 5 else ''}", file=sys.stderr)
    return pairs


def _run_directory(pipe, args, opts, coords):
    """Batch a directory: group same-shape pairs, stack up to --batch."""
    pairs = _pair_directory(args.image, args.trimap)
    if not pairs:
        print("[cli] no image/trimap pairs found", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    if args.matted_out:
        os.makedirs(args.matted_out, exist_ok=True)

    # group by header-declared size (no pixel decode) so a large folder
    # never holds more than one --batch chunk of float32 pixels in RAM
    from PIL import Image
    groups: dict = {}   # (img_WH, tri_WH) -> [(stem, img_path, tri_path)]
    for stem, ipath, tpath in pairs:
        with Image.open(ipath) as im, Image.open(tpath) as tm:
            key = (im.size, tm.size)
        groups.setdefault(key, []).append((stem, ipath, tpath))

    n_done = 0
    t0 = time.time()
    for items in groups.values():
        for i in range(0, len(items), args.batch):
            chunk = items[i:i + args.batch]
            imgs = np.stack([load_unit_image(p, 3) for _, p, _ in chunk])
            tris = np.stack([load_unit_image(p, 1)[..., 0] for _, _, p in chunk])
            extra = {} if coords is None else {"coords": np.repeat(coords, len(chunk), axis=0)}
            alpha, matted = pipe(imgs, tris, options=opts, **extra)
            alpha, matted = alpha.cpu().numpy(), matted.cpu().numpy()
            for j, (stem, _, _) in enumerate(chunk):
                save_png(os.path.join(args.out, stem + ".png"), alpha[j])
                if args.matted_out:
                    save_png(os.path.join(args.matted_out, stem + ".png"), matted[j])
            n_done += len(chunk)
            print(f"[cli] {n_done}/{len(pairs)} done "
                  f"({(time.time() - t0) / n_done:.2f}s/image)", file=sys.stderr)
    return 0


def print_launches(tag: str = "cli"):
    """The hand kernels' launch counts of this process, one JSON line on
    stderr, so a caller can see which kernels the run went through."""
    import json
    from .ops._build import Kernel
    counts = {k.name: k.launches for k in Kernel.registry}
    print(f"[{tag}] hand-kernel launches: {json.dumps(counts)}", file=sys.stderr)


def random_pipeline(cfg, *, device, policy, **pipeline_kw):
    """A pipeline on the model of ``cfg`` with seeded random weights (seed 0)."""
    import torch
    from .models.init import init_random_
    from .models.sdmatte import SDMatte
    from .pipeline import MattingPipeline
    with torch.device("meta"):
        model = SDMatte(cfg)
    init_random_(model, seed=0, device=device)
    return MattingPipeline(model, policy=policy, device=device, **pipeline_kw)


def vitmatte_pipeline(args, *, device, policy):
    """``--model vitmatte``: seeded random weights (seed 0), or a
    VitMatteForImageMatting checkpoint."""
    import torch
    from .configs import ViTMatteConfig
    from .models.vitmatte import ViTMatte
    from .pipeline.vitmatte import ViTMattePipeline
    cfg = ViTMatteConfig.tiny() if args.tiny else ViTMatteConfig()
    if args.random_weights or args.tiny:
        from .models.init import init_random_
        with torch.device("meta"):
            model = ViTMatte(cfg)
        init_random_(model, seed=0, device=device)
    else:
        from .checkpoint import load_vitmatte_checkpoint
        model = ViTMatte(cfg)
        report = load_vitmatte_checkpoint(model, args.ckpt)
        if report.missing or report.unexpected or report.mismatched:
            raise SystemExit(f"[cli] {args.ckpt} is not a ViTMatte checkpoint of this "
                             f"config: {report.summary()}")
    return ViTMattePipeline(model, policy=policy, device=device,
                            weight_storage=args.weight_storage)


def main(argv=None):
    ap = argparse.ArgumentParser(description="SDMatte matting CLI (PyTorch/CUDA)")
    ap.add_argument("--model", default="sdmatte", choices=["sdmatte", "vitmatte"],
                    help="sdmatte (SDMatte at --size) or vitmatte (ViTMatte at the "
                         "photo's own resolution)")
    ap.add_argument("--image", required=True,
                    help="input image PNG, or a directory of images")
    ap.add_argument("--trimap", required=True,
                    help="trimap PNG, or a directory (pairs by stem)")
    ap.add_argument("--out", required=True,
                    help="alpha PNG output path (directory in batch mode)")
    ap.add_argument("--matted-out", default=None,
                    help="matted image PNG path (directory in batch mode)")
    ap.add_argument("--batch", type=int, default=4,
                    help="directory mode: images per pipeline call")
    ap.add_argument("--ckpt", default="SDMatte.safetensors",
                    help="checkpoint name or path")
    ap.add_argument("--size", type=int, default=1024,
                    choices=[512, 640, 768, 896, 1024])
    ap.add_argument("--mode", default="alpha_only",
                    choices=["alpha_only", "matted_rgba", "matted_rgb"])
    ap.add_argument("--refine", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--tc", type=float, default=0.8, help="trimap constraint")
    ap.add_argument("--transparent", action="store_true")
    ap.add_argument("--prompt-type", default="trimap",
                    choices=["trimap", "mask", "bbox_mask", "point_mask",
                             "auto_mask"],
                    help="visual-prompt type; --trimap supplies the prompt "
                         "mask for all types")
    ap.add_argument("--coords", default=None,
                    help="comma-separated prompt coords (bbox: x0,y0,x1,y1 "
                         "normalized; points: x1,y1,x2,y2,...)")
    ap.add_argument("--cpu", action="store_true",
                    help="fp32 on the CPU (the default is bf16 on the CUDA card)")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--random-weights", action="store_true",
                    help="skip checkpoint loading (smoke runs)")
    ap.add_argument("--tiny", action="store_true",
                    help="CI-size model, random weights (smoke-tests the "
                         "full CLI path in seconds)")
    ap.add_argument("--speed-mode", default="off",
                    choices=["off", "aux_half", "rgb_half", "decode_half",
                             "fast", "fastest"],
                    help="out-of-parity speed modes: encode the trimap "
                         "(aux_half) or photo (rgb_half) at half size, decode "
                         "at half size (decode_half); fast = aux_half + "
                         "decode_half, fastest = all three; never the default")
    ap.add_argument("--weight-storage", default="fp",
                    choices=["fp", "int8"],
                    help="int8 = weights resident as int8 + per-channel "
                         "scale, dequantized at use")
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error(f"--batch must be >= 1 (got {args.batch})")
    if args.prompt_type == "point_mask" and not args.coords:
        # without coords the pipeline falls back to the bbox default
        # [0,0,1,1], which the point branch would silently embed as two
        # corner points
        ap.error("--prompt-type point_mask requires --coords x1,y1,...")
    if args.coords:
        try:
            [float(v) for v in args.coords.split(",")]
        except ValueError:
            ap.error(f"--coords must be comma-separated numbers, got "
                     f"{args.coords!r}")
    if args.model == "vitmatte" and (args.coords or args.prompt_type != "trimap"
                                     or args.speed_mode != "off"):
        ap.error("--model vitmatte takes a trimap alone: no --coords, --prompt-type "
                 "or --speed-mode")
    if args.model == "vitmatte" and not (args.random_weights or args.tiny
                                         or os.path.isfile(args.ckpt)):
        ap.error(f"--model vitmatte needs --ckpt <VitMatteForImageMatting checkpoint> or "
                 f"--random-weights; {args.ckpt!r} is no file")

    import torch
    from .configs import SDMatteConfig
    from .core.dtypes import BF16, FP32
    from .pipeline import PipelineOptions
    from .pipeline.matting import resolve_device

    dir_mode = os.path.isdir(args.image)
    if dir_mode != os.path.isdir(args.trimap):
        ap.error("--image and --trimap must both be files or both be "
                 "directories")
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"[cli] {e} (or pass --cpu)", file=sys.stderr)
        return 2
    if not dir_mode:
        image = load_unit_image(args.image, 3)
        trimap = load_unit_image(args.trimap, 1)[..., 0]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    policy = FP32 if (args.cpu or args.fp32) else BF16
    if args.model == "vitmatte":
        pipe = vitmatte_pipeline(args, device=device, policy=policy)
    elif args.random_weights or args.tiny:
        cfg = SDMatteConfig.tiny() if args.tiny else SDMatteConfig()
        pipe = random_pipeline(cfg, device=device, policy=policy,
                               speed_mode=args.speed_mode,
                               weight_storage=args.weight_storage)
    else:
        from .api.node import get_pipeline
        if os.path.isfile(args.ckpt):
            from .api import comfy_shim
            comfy_shim.add_model_folder_path(
                "SDMatte", os.path.dirname(os.path.abspath(args.ckpt)))
            args.ckpt = os.path.basename(args.ckpt)
        pipe = get_pipeline(args.ckpt, force_cpu=args.cpu,
                            policy_name="fp32" if args.fp32 else "bf16",
                            speed_mode=args.speed_mode,
                            weight_storage=args.weight_storage)
    sync()
    print(f"[cli] model ready in {time.time() - t0:.1f}s", file=sys.stderr)

    if args.model == "vitmatte":
        from .pipeline.vitmatte import ViTMatteOptions
        opts = ViTMatteOptions(output_mode=args.mode, mask_refine=args.refine,
                               trimap_constraint=args.tc, is_transparent=args.transparent)
    else:
        opts = PipelineOptions(inference_size=args.size,
                               is_transparent=args.transparent,
                               output_mode=args.mode, mask_refine=args.refine,
                               trimap_constraint=args.tc,
                               aux_input=args.prompt_type)
    coords = None
    if args.coords:
        coords = np.asarray([[float(v) for v in args.coords.split(",")]],
                            np.float32)
    if dir_mode:
        rc = _run_directory(pipe, args, opts, coords)
        if device.type == "cuda":
            print_launches()
        return rc
    t0 = time.time()
    alpha, matted = pipe(image, trimap, options=opts,
                         **({} if coords is None else {"coords": coords}))
    sync()
    print(f"[cli] matted in {time.time() - t0:.2f}s", file=sys.stderr)
    if device.type == "cuda":
        print_launches()

    save_png(args.out, alpha[0].cpu().numpy())
    if args.matted_out:
        save_png(args.matted_out, matted[0].cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
