"""Headless ComfyUI workflow runner of the port (examples/run_workflow.py):
runs a workflow JSON end to end through the port's ``SDMatteApply`` node,
outside a ComfyUI install.

It is the minimal host: it parses the UI-format graph (the ``nodes`` and
``links`` arrays), implements the builtin nodes the example graphs use
(LoadImage, LoadImageMask, MaskToImage, PreviewImage, SaveImage,
MaskPreview+, a no-op Bookmark and a deterministic SegmentAnything
stand-in), runs the graph in topological order and drives the node as
ComfyUI's executor does: torch tensors in and out, widget values bound with
link inputs in ``INPUT_TYPES`` order.  It runs the bundled
``examples/workflow_sdmatte_tpu.json`` and the reference plugin's production
workflow (4x SDMatteApply fed by SegmentAnything trimaps, 8 mask previews,
1 save).

Usage:
    python -m sdmatte_tpu_torch.workflow examples/workflow_sdmatte_tpu.json \\
        --out-dir out/ [--random-weights] [--tiny] [--cpu]

It runs bf16 on the CUDA card; ``--cpu`` runs the node on the CPU, and
without ``--cpu`` and without CUDA it exits 2.  ``--random-weights`` gives
the node a pipeline with seeded random weights instead of a checkpoint (bf16
on the card; fp32 on the plain versions under ``--cpu`` or ``--tiny``);
``--tiny`` shrinks it to the CI config.  Without them the node resolves its
checkpoint as it does inside ComfyUI.  At the end the hand kernels' launch
counts are printed on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch


# --------------------------------------------------------- builtin nodes ---

class LoadImage:
    """ComfyUI builtin: filename widget -> (IMAGE (B,H,W,3) [0,1], MASK).

    Workflow JSONs exported from a live ComfyUI name files in that install's
    ``input/`` directory (hashed upload names), which do not travel with the
    JSON.  When the named file is missing, the images shipped next to the
    workflow stand in, round robin, so that a production workflow runs
    against the photos that come with it."""

    WIDGETS = ("image", "upload")

    def __init__(self, asset_dir):
        self.asset_dir = asset_dir
        self._fallback_idx = 0

    def _resolve(self, name):
        path = os.path.join(self.asset_dir, name)
        if os.path.exists(path):
            return path
        pool = sorted(
            f for f in os.listdir(self.asset_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
        if not pool:
            raise FileNotFoundError(f"{path} (and no fallback images in "
                                    f"{self.asset_dir})")
        sub = pool[self._fallback_idx % len(pool)]
        self._fallback_idx += 1
        print(f"  [LoadImage] '{name}' not found; substituting shipped "
              f"asset '{sub}'")
        return os.path.join(self.asset_dir, sub)

    def run(self, widgets, inputs):
        from PIL import Image
        path = self._resolve(widgets[0])
        arr = np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0
        img = torch.from_numpy(arr[None, ..., :3])
        mask = torch.from_numpy(1.0 - arr[None, ..., 3])
        return img, mask


class LoadImageMask:
    """ComfyUI builtin: image file + channel selector -> MASK (B,H,W)."""

    WIDGETS = ("image", "channel", "upload")

    def __init__(self, asset_dir):
        self.asset_dir = asset_dir

    def run(self, widgets, inputs):
        from PIL import Image
        path = os.path.join(self.asset_dir, widgets[0])
        channel = widgets[1] if len(widgets) > 1 else "alpha"
        img = Image.open(path)
        if channel == "alpha" and img.mode in ("RGBA", "LA"):
            arr = np.asarray(img.convert("RGBA"), np.float32)[..., 3] / 255.0
        else:
            idx = {"red": 0, "green": 1, "blue": 2}.get(channel, 0)
            rgb = np.asarray(img.convert("RGB"), np.float32) / 255.0
            arr = rgb[..., idx]
        return (torch.from_numpy(arr[None]),)


class MaskToImage:
    WIDGETS = ()

    def run(self, widgets, inputs):
        (mask,) = inputs
        return (torch.stack([mask] * 3, dim=-1),)


class _ImageWriter:
    WIDGETS = ("filename_prefix",)

    def __init__(self, out_dir, default_prefix):
        self.out_dir = out_dir
        self.default_prefix = default_prefix
        self.calls = 0          # distinct sink nodes share one writer

    def run(self, widgets, inputs):
        from PIL import Image
        prefix = widgets[0] if widgets else self.default_prefix
        self.calls += 1
        # linkless extras (SaveImage's optional filename_prefix input) arrive
        # as None placeholders: the image tensor is the first real input
        images = next(i for i in inputs if i is not None)
        arr = np.clip(np.asarray(images.detach().cpu().numpy()
                                 if hasattr(images, "detach") else images),
                      0, 1)
        if arr.ndim == 3:                      # MASK fed straight to a sink
            arr = arr[..., None].repeat(3, -1)
        os.makedirs(self.out_dir, exist_ok=True)
        paths = []
        for i, im in enumerate(arr):
            p = os.path.join(self.out_dir,
                             f"{prefix}_{self.calls:02d}_{i:03d}.png")
            Image.fromarray((im * 255 + 0.5).astype(np.uint8)).save(p)
            paths.append(p)
        print(f"  wrote {', '.join(paths)}")
        return ()


def PreviewImage(out_dir):
    return _ImageWriter(out_dir, "preview")


def SaveImage(out_dir):
    return _ImageWriter(out_dir, "output")


def MaskPreview(out_dir):
    """ComfyUI_essentials ``MaskPreview+``: a MASK sink, the same writer (its
    run lifts (B,H,W) masks to grayscale RGB)."""
    return _ImageWriter(out_dir, "mask_preview")


class Bookmark:
    """rgthree ``Bookmark``: a UI affordance, no inputs, no outputs."""

    WIDGETS = ()

    def run(self, widgets, inputs):
        return ()


class SegmentAnythingStandin:
    """Deterministic stand-in for ``LayerMask: SegmentAnythingUltra V2``.

    The real node runs SAM and GroundingDINO (multi-GB models of a
    third-party pack) to give the subject matte that the reference workflow
    feeds to SDMatteApply as its trimap.  This one gives a deterministic
    coarse subject mask instead: an Otsu threshold on luminance, the side
    that holds the image center kept (the 'subject' prompt), the boundary
    softened by box blurs so that a fg/unknown/bg band exists, the shape
    SDMatte's trimap conditioning reads.  Outputs (image, mask) like the
    real node.
    """

    WIDGETS = ()

    @staticmethod
    def _otsu(lum):
        hist, edges = np.histogram(lum, bins=256, range=(0.0, 1.0))
        p = hist.astype(np.float64) / max(hist.sum(), 1)
        w = np.cumsum(p)
        mu = np.cumsum(p * np.arange(256))
        mu_t = mu[-1]
        denom = w * (1.0 - w)
        denom[denom == 0] = np.nan
        sigma_b = (mu_t * w - mu) ** 2 / denom
        if not np.isfinite(sigma_b).any():
            # uniform image: every pixel in one bin, no valid split; any
            # threshold is equivalent, so the midpoint
            return 0.5
        k = int(np.nanargmax(sigma_b))
        return (k + 0.5) / 256.0

    @staticmethod
    def _box_blur(m, r):
        """(2r+1)-tap box filter per axis via prefix sums, edge-padded."""
        if r < 1:
            return m

        def one_axis(a):
            pad = np.pad(a, ((r, r), (0, 0)), mode="edge")
            c = np.vstack([np.zeros((1, pad.shape[1]), pad.dtype),
                           np.cumsum(pad, axis=0)])
            return (c[2 * r + 1:] - c[:-(2 * r + 1)]) / (2 * r + 1)

        return one_axis(one_axis(m).T).T

    def run(self, widgets, inputs):
        img = inputs[0]  # (B,H,W,3) torch
        arr = img.detach().cpu().numpy()[0]
        lum = arr @ np.asarray([0.299, 0.587, 0.114], np.float32)
        fg = lum > self._otsu(lum)
        h, w = fg.shape
        if not fg[h // 2, w // 2]:          # subject = side containing center
            fg = ~fg
        m = fg.astype(np.float32)
        r = max(min(h, w) // 64, 1)
        for _ in range(2):
            m = self._box_blur(m, r)
        m = np.clip(m[:h, :w], 0.0, 1.0).astype(np.float32)
        return img, torch.from_numpy(m[None])


def builtin_nodes(asset_dir: str, out_dir: str) -> dict:
    """The builtin nodes by ComfyUI type name: inputs read from
    ``asset_dir``, PNGs written to ``out_dir``."""
    return {
        "LoadImage": LoadImage(asset_dir),
        "LoadImageMask": LoadImageMask(asset_dir),
        "MaskToImage": MaskToImage(),
        "PreviewImage": PreviewImage(out_dir),
        "SaveImage": SaveImage(out_dir),
        "MaskPreview+": MaskPreview(out_dir),
        "Bookmark (rgthree)": Bookmark(),
        "LayerMask: SegmentAnythingUltra V2": SegmentAnythingStandin(),
    }


# ------------------------------------------------------------- executor ---

def _widget_names(node_cls) -> list:
    """Widget inputs, in INPUT_TYPES order (ComfyUI widget-value layout):
    everything whose type spec is a combo list or a primitive type string."""
    names = []
    schema = node_cls.INPUT_TYPES()
    for section in ("required", "optional"):
        for name, spec in schema.get(section, {}).items():
            t = spec[0]
            if isinstance(t, list) or t in ("INT", "FLOAT", "BOOLEAN", "STRING"):
                names.append(name)
    return names


def execute_workflow(graph: dict, registry: dict, *, verbose: bool = True,
                     timings: Optional[dict] = None):
    """Topologically run the UI-format graph; returns {node_id: outputs}.

    ``timings``, if given, receives each node's own seconds (its call alone,
    not the nodes it waits on) by node id."""
    nodes = {n["id"]: n for n in graph["nodes"]}
    # links: [id, src_node, src_slot, dst_node, dst_slot, type]
    links = {l[0]: (l[1], l[2]) for l in graph.get("links", [])}

    done: dict = {}

    def run_node(nid):
        if nid in done:
            return done[nid]
        node = nodes[nid]
        impl = registry[node["type"]]
        link_inputs = []
        for inp in node.get("inputs", []):
            if inp.get("link") is None:
                link_inputs.append(None)
                continue
            src_id, src_slot = links[inp["link"]]
            link_inputs.append(run_node(src_id)[src_slot])
        widgets = node.get("widgets_values", [])
        if verbose:
            print(f"[{nid}] {node['type']}")
        t0 = time.perf_counter()
        if hasattr(impl, "run"):                       # builtin host node
            out = impl.run(widgets, link_inputs)
        else:                                          # real plugin node
            fn = getattr(impl, impl.FUNCTION)
            kwargs = {}
            wi = 0
            widget_names = _widget_names(type(impl))
            # newer ComfyUI exports list widget-backed inputs in `inputs`
            # too (with "link": null): only an actual link binds a value,
            # everything else falls through to positional widget binding
            input_names = [i["name"] for i in node.get("inputs", [])]
            linked = {i["name"] for i in node.get("inputs", [])
                      if i.get("link") is not None}
            schema = type(impl).INPUT_TYPES()
            for section in ("required", "optional"):
                for name in schema.get(section, {}):
                    if name in linked:
                        kwargs[name] = link_inputs[input_names.index(name)]
                        # a widget converted to a link input still serializes
                        # its (stale) widgets_values slot: consume it so the
                        # remaining positional bindings stay aligned
                        if name in widget_names:
                            wi += 1
                    elif name in widget_names and wi < len(widgets):
                        kwargs[name] = widgets[wi]
                        wi += 1
            out = fn(**kwargs)
        if timings is not None:
            timings[nid] = time.perf_counter() - t0
        done[nid] = out
        return out

    for nid in nodes:          # memoized: each node executes exactly once
        run_node(nid)
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run a ComfyUI workflow JSON through the port's SDMatteApply node")
    ap.add_argument("workflow")
    ap.add_argument("--out-dir", required=True,
                    help="directory for the PNGs the graph's sinks write")
    ap.add_argument("--random-weights", action="store_true",
                    help="seeded random model (no checkpoint)")
    ap.add_argument("--tiny", action="store_true",
                    help="CI-size model config, random weights (a fast smoke run)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the node on the CPU (the default is the CUDA card)")
    args = ap.parse_args(argv)

    from .api import node as node_mod
    from .cli import print_launches, random_pipeline
    from .configs import SDMatteConfig
    from .core.dtypes import BF16, FP32
    from .pipeline.matting import resolve_device

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"[workflow] {e} (or pass --cpu)", file=sys.stderr)
        return 2

    get_pipeline = node_mod.get_pipeline
    if args.random_weights or args.tiny:
        cfg = SDMatteConfig.tiny() if args.tiny else SDMatteConfig()
        plain = args.tiny or args.cpu
        pipe = random_pipeline(cfg, device=device, policy=FP32 if plain else BF16,
                               impl="plain" if plain else "auto")
        node_mod.get_pipeline = lambda *a, **k: pipe
        print(f"[workflow] random-weights pipeline "
              f"({'tiny' if args.tiny else 'full'} config, {device.type})")
    elif args.cpu:
        node_mod.get_pipeline = lambda name, **kw: get_pipeline(
            name, **{**kw, "force_cpu": True})
    try:
        with open(args.workflow) as f:
            graph = json.load(f)
        asset_dir = os.path.dirname(os.path.abspath(args.workflow))
        registry = builtin_nodes(asset_dir, args.out_dir)
        registry["SDMatteApply"] = node_mod.SDMatteApply()
        with torch.inference_mode():     # as ComfyUI's prompt worker runs nodes
            execute_workflow(graph, registry)
    finally:
        node_mod.get_pipeline = get_pipeline
    print(f"[workflow] done -> {args.out_dir}")
    if device.type == "cuda":
        print_launches("workflow")
    return 0


if __name__ == "__main__":
    sys.exit(main())
