"""One-command real-weight parity pack of the port (the stages, flags and
report of sdmatte_tpu/parity_pack.py).

    python -m sdmatte_tpu_torch.parity_pack --ckpt SDMatte.safetensors \\
        [--image img.png --trimap tri.png] [--size 512] [--out report.json] [--cpu]

What a host that has the real checkpoint runs, in one cold run, to check the
port's loader and model against the file:

  1. **header against manifest**: the file's safetensors header (its JSON,
     read without the tensors) diffed against checkpoint/manifest.py's key
     and shape set, derived by hand from the reference topology, so it is a
     check independent of the port's modules; the legacy VAE attention names
     are accepted.  A file whose keys share a wrapper prefix fails here.
  2. **load report**: the strict=False load into a seeded ``SDMatte``
     (checkpoint/loader.py); nothing missing, unexpected or mismatched, bar
     the known parameterless buffers.
  3. **layout signatures**: each tensor as checkpoint/safetensors_io.py reads
     it from the file, against the loaded parameter it maps to.  Both are in
     torch layout (conv OIHW, linear (out, in)), so one signature serves
     both: the sum and std, per-output-channel means (axis 0), per-input-
     channel means (axis 1) and, for a conv, the 3x3 tap grid (axes 2, 3).
     Plain moments are blind to a transpose; these break under any
     permutation or tap flip between the file and the module, with no
     golden values needed (the file is ground truth, the loader is what can
     be wrong).  ``--emit-stats`` freezes the file's signatures to JSON,
     ``--check-stats`` compares the file against such a JSON.
  4. **golden dump**: one fp32 forward with ``return_intermediates`` on a
     given or synthetic image and trimap, on the card (the hand kernels) or,
     with ``--cpu``, on the CPU (the plain versions); alpha and each
     intermediate go to an ``.npz`` in the JAX package's keys and NHWC
     layout, so either package's dump diffs against the other's key by key.
  5. **quality**: SAD / MSE / Grad / Conn (eval/) of the port's pipeline on
     two synthetic composites.

Each stage's report entry carries its seconds.  The exit code is 0 when
every stage passed, 1 when one failed, 2 when the card was asked for and
there is none.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

_IGNORABLE_SUFFIXES = ("position_ids", "num_batches_tracked")


# ------------------------------------------------------------ stage 1 ---

def read_header(path: str) -> Dict[str, tuple]:
    """{key: shape} of a safetensors file, read from its header only."""
    from .checkpoint.safetensors_io import read_header as header_of
    header, _ = header_of(path)
    return {k: tuple(v["shape"]) for k, v in header.items()}


def diff_keys(expected: Dict[str, tuple], actual: Dict[str, tuple]) -> list:
    problems = []
    for k, shp in expected.items():
        if k not in actual:
            problems.append(f"missing from ckpt: {k} {list(shp)}")
        elif tuple(actual[k]) != tuple(shp):
            problems.append(f"shape mismatch: {k} expected {list(shp)} "
                            f"got {list(actual[k])}")
    for k in actual:
        if k not in expected and not k.endswith(_IGNORABLE_SUFFIXES):
            problems.append(f"unexpected in ckpt: {k} {list(actual[k])}")
    return problems


# ------------------------------------------------------------ stage 3 ---

def signatures(t: torch.Tensor) -> dict:
    """Layout signatures of a tensor in torch layout (conv OIHW, linear
    (out, in), 1-D as it is), in float64 on the tensor's device, as numpy."""
    a = t.detach().to(torch.float64)
    sig = {"sum": a.sum(), "std": a.std(unbiased=False)}
    if a.ndim == 4:
        sig["out_mean"] = a.mean(dim=(1, 2, 3))
        sig["in_mean"] = a.mean(dim=(0, 2, 3))
        sig["tap_grid"] = a.mean(dim=(0, 1))
    elif a.ndim == 2:
        sig["out_mean"] = a.mean(dim=1)
        sig["in_mean"] = a.mean(dim=0)
    return {k: v.cpu().numpy() for k, v in sig.items()}


def check_loaded_stats(model: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                       *, rtol: float = 1e-3, atol: float = 1e-5) -> list:
    """Each file tensor against the module parameter its key names (after
    the loader's wrapper-prefix and legacy-name rules) by the layout
    signatures.  Returns a list of failures."""
    from .checkpoint.loader import normalize_key, strip_wrapper_prefix
    targets = model.state_dict(keep_vars=True)
    wrapper = strip_wrapper_prefix(tensors.keys())
    failures, checked = [], 0
    for key, raw in tensors.items():
        if key.endswith(_IGNORABLE_SUFFIXES):
            continue
        target = targets.get(normalize_key(key[len(wrapper):]))
        if target is None or tuple(target.shape) != tuple(raw.shape):
            continue                     # the load report covers these
        want = signatures(raw.to(target.device))
        got = signatures(target)
        for name, w in want.items():
            if not np.allclose(w, got[name], rtol=rtol, atol=atol):
                failures.append(f"{key}: signature '{name}' mismatch "
                                f"(layout transposition or corruption)")
        checked += 1
    if checked == 0:
        failures.append("stats check matched zero tensors (wrong module?)")
    return failures


def emit_stats(tensors: Dict[str, torch.Tensor]) -> dict:
    """The file's signatures, frozen for regression checks without it."""
    return {key: {k: (float(v) if v.ndim == 0 else v.round(9).tolist())
                  for k, v in signatures(raw).items()}
            for key, raw in tensors.items()}


def check_frozen_stats(tensors: Dict[str, torch.Tensor], frozen: dict,
                       *, rtol: float = 1e-6, atol: float = 1e-9) -> list:
    failures = []
    for key, sig in frozen.items():
        if key not in tensors:
            failures.append(f"frozen-stats key absent from ckpt: {key}")
            continue
        now = signatures(tensors[key])
        for name, v in sig.items():
            if not np.allclose(np.asarray(v), now[name], rtol=rtol, atol=atol):
                failures.append(f"{key}: frozen signature '{name}' drifted")
    return failures


# ------------------------------------------------------------ stage 4 ---

def golden_inputs(size: int, image: Optional[str] = None,
                  trimap: Optional[str] = None):
    """(image (1, S, S, 3), trimap (1, S, S, 1)) in [0, 1], numpy: the given
    files resized (antialiased bilinear), else a synthetic ramp and a
    three-band trimap."""
    if image and trimap:
        from .core import imaging
        from .utils.images import load_unit_image
        img = torch.from_numpy(load_unit_image(image, 3))[None]
        tri = torch.from_numpy(load_unit_image(trimap, 1))[None]
        return (imaging.resize_bilinear(img, size, size).numpy(),
                imaging.resize_bilinear(tri, size, size).numpy())
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([yy, xx, (yy + xx) / 2], -1)[None]
    tri = np.where(yy < 0.4, 1.0, np.where(yy > 0.6, 0.0, 0.5))[None, ..., None]
    return img.astype(np.float32), tri.astype(np.float32)


def golden_dump(model, img: np.ndarray, tri: np.ndarray, *, impl: str = "auto") -> dict:
    """One fp32 forward with ``return_intermediates`` on the model's device:
    {"alpha", "rgb_latent", "aux_latent", "aux_tokens", "unet_out",
    "decoded"} as NHWC numpy (the JAX package's layout; aux_tokens (B, L,
    C))."""
    dev = next(model.parameters()).device

    def nchw(x):
        return torch.from_numpy(x * 2.0 - 1.0).permute(0, 3, 1, 2).to(dev)

    data = {"image": nchw(img), "trimap": nchw(tri),
            "trimap_coords": torch.tensor([[0.0, 0.0, 1.0, 1.0]], device=dev),
            "is_trans": torch.zeros(1, device=dev)}
    with torch.no_grad():
        alpha, inter = model(data, impl=impl, return_intermediates=True)
    dump = {"alpha": alpha}
    dump.update({k: v for k, v in inter.items() if isinstance(v, torch.Tensor)})
    return {k: (v.permute(0, 2, 3, 1) if v.ndim == 4 else v).float().cpu().numpy()
            for k, v in dump.items()}


# ------------------------------------------------------------------ run ---

def run(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sdmatte_tpu_torch.parity_pack",
        description="one-command real-weight parity validation of the port")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny CI config (synthetic-checkpoint self-test)")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--image", default=None)
    ap.add_argument("--trimap", default=None)
    ap.add_argument("--golden-out", default="parity_golden.npz")
    ap.add_argument("--out", default=None, help="write JSON report here")
    ap.add_argument("--skip-quality", action="store_true")
    ap.add_argument("--skip-golden", action="store_true")
    ap.add_argument("--emit-stats", default=None,
                    help="freeze the file's tensor signatures to this JSON")
    ap.add_argument("--check-stats", default=None,
                    help="compare ckpt against a frozen signatures JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, on the plain versions (the default "
                         "is the CUDA card)")
    args = ap.parse_args(argv)

    from .checkpoint import manifest, safetensors_io
    from .checkpoint.loader import load_sdmatte_checkpoint
    from .configs import SDMatteConfig
    from .models.init import init_random_
    from .models.sdmatte import SDMatte
    from .pipeline.matting import resolve_device

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"[parity_pack] {e}", file=sys.stderr)
        return 2
    cfg = SDMatteConfig.tiny() if args.tiny else SDMatteConfig()
    report: dict = {"ckpt": args.ckpt, "tiny": args.tiny, "device": str(device),
                    "stages": {}}
    failed = False
    t0 = time.perf_counter()

    def stage(name, problems, **extra):
        nonlocal failed, t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        ok = not problems
        report["stages"][name] = {"ok": ok, "problems": problems[:50],
                                  "seconds": seconds, **extra}
        print(f"[parity_pack] {name}: "
              f"{'OK' if ok else f'FAIL ({len(problems)} problems)'} ({seconds:.2f} s)",
              flush=True)
        for p in problems[:10]:
            print(f"    {p}", flush=True)
        failed = failed or not ok
        t0 = time.perf_counter()

    # 1. header against manifest
    expected = manifest.expected_keys(cfg)
    header = read_header(args.ckpt)
    problems = diff_keys(expected, header)
    if problems and not diff_keys(manifest.legacy_vae_attn_variant(expected), header):
        problems = []
        report["stages"]["header_vs_manifest_note"] = \
            "matched via legacy VAE attention key naming"
    stage("header_vs_manifest", problems)

    # 2. load report, into a seeded fp32 model on the device
    with torch.device("meta"):
        model = SDMatte(cfg)
    init_random_(model, seed=0, device=device)
    lrep = load_sdmatte_checkpoint(model, args.ckpt)
    model.eval()
    problems = ([f"missing: {k}" for k in lrep.missing]
                + [f"unexpected: {k}" for k in lrep.unexpected]
                + [f"mismatched: {k} {a} vs {b}" for k, a, b in lrep.mismatched])
    report["stages"]["load_summary"] = lrep.summary()
    stage("load_report", problems)

    # 3. layout signatures (+ the frozen-stats modes)
    tensors = safetensors_io.read(args.ckpt)
    stage("layout_signatures", check_loaded_stats(model, tensors))
    if args.emit_stats:
        with open(args.emit_stats, "w") as f:
            json.dump(emit_stats(tensors), f)
        print(f"[parity_pack] froze signatures -> {args.emit_stats}", flush=True)
    if args.check_stats:
        with open(args.check_stats) as f:
            frozen = json.load(f)
        stage("frozen_signatures", check_frozen_stats(tensors, frozen))
    del tensors

    # 4. golden dump (fp32 forward, per-module activations)
    if not args.skip_golden:
        img, tri = golden_inputs(args.size, args.image, args.trimap)
        dump = golden_dump(model, img, tri)
        np.savez(args.golden_out, **dump)
        alpha_mean = float(dump["alpha"].mean())
        print(f"[parity_pack] golden dump -> {args.golden_out} "
              f"(alpha mean {alpha_mean:.4f})", flush=True)
        stage("golden", [] if np.isfinite(dump["alpha"]).all() else ["alpha is not finite"],
              out=args.golden_out, alpha_mean=alpha_mean)

    # 5. quality metrics on the synthetic-composite set
    if not args.skip_quality:
        from .eval import metrics, synthetic
        from .pipeline import MattingPipeline, PipelineOptions
        pipe = MattingPipeline(model, device=device)
        size = 64 if args.tiny else min(args.size, 256)
        rows = []
        for case in synthetic.make_eval_set(size)[:2]:
            a, _ = pipe(case["image"][None], case["trimap"][None],
                        options=PipelineOptions(inference_size=size, mask_refine=False))
            rows.append(metrics.evaluate(a[0].cpu().numpy(), case["alpha_gt"],
                                         trimap=case["trimap"]))
        agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        print(f"[parity_pack] quality (synthetic composites): {agg}", flush=True)
        stage("quality", [], **agg)

    report["ok"] = not failed
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(f"[parity_pack] {'PASS' if not failed else 'FAIL'}", flush=True)
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(run())
