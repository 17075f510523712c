"""Asset management: weight + config acquisition with atomic writes (the
port's copy of sdmatte_tpu/assets/manager.py).

Search registered model dirs, else stream-download from Hugging Face with a
tmp file and an atomic ``os.replace``, content-length verification,
concurrent-writer tolerance, a requests -> urllib fallback, interrupt-safe
cleanup, and a per-file non-fatal config manifest.  The fetch function is
injectable (``local_copy_fetch`` copies from a local tree, for runs without
a network), and search paths come from an explicit registry (api/comfy_shim.py).
"""

from __future__ import annotations

import os
import shutil
import urllib.request
from typing import Callable, Dict, List, Optional

MODEL_URLS = {
    "SDMatte.safetensors":
        "https://huggingface.co/1038lab/SDMatte/resolve/main/SDMatte.safetensors",
    "SDMatte_plus.safetensors":
        "https://huggingface.co/1038lab/SDMatte/resolve/main/SDMatte_plus.safetensors",
}

SD21_CONFIG_BASE = "https://huggingface.co/Manojb/stable-diffusion-2-1-base/resolve/main"
# config-only file set (reference sdmatte_nodes.py:20-31)
SD21_CONFIG_MANIFEST = [
    "model_index.json",
    "text_encoder/config.json",
    "vae/config.json",
    "unet/config.json",
    "scheduler/scheduler_config.json",
    "tokenizer/tokenizer_config.json",
    "tokenizer/merges.txt",
    "tokenizer/vocab.json",
    "tokenizer/special_tokens_map.json",
    "feature_extractor/preprocessor_config.json",
]


class AssetError(RuntimeError):
    pass


def _default_fetch(url: str, dst: str, progress: bool = True) -> None:
    """Stream url -> dst with content-length verification; requests with
    urllib fallback."""
    try:
        import requests
    except ImportError:
        requests = None
    if requests is None:
        urllib.request.urlretrieve(url, dst)
        return
    bar = None
    with requests.get(url, stream=True, timeout=60) as resp:
        resp.raise_for_status()
        total = int(resp.headers.get("content-length", 0) or 0)
        if progress and total:
            try:
                from tqdm import tqdm
                bar = tqdm(desc=os.path.basename(dst), total=total, unit="iB",
                           unit_scale=True, unit_divisor=1024)
            except ImportError:
                bar = None
        with open(dst, "wb") as f:
            for chunk in resp.iter_content(chunk_size=1 << 20):
                if chunk:
                    f.write(chunk)
                    if bar:
                        bar.update(len(chunk))
        if bar:
            bar.close()
        if total and os.path.getsize(dst) != total:
            raise AssetError(
                f"incomplete download: {os.path.getsize(dst)} != {total} for {url}")


def _atomic_download(url: str, target: str,
                     fetch: Callable[[str, str], None]) -> str:
    """tmp-file + atomic replace, concurrent-winner check, cleanup on error."""
    os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
    tmp = target + ".tmp"
    try:
        fetch(url, tmp)
        # another process may have finished first — keep the winner
        if os.path.isfile(target) and os.path.getsize(target) > 0:
            os.remove(tmp)
            return target
        os.replace(tmp, target)
        return target
    except BaseException:          # including KeyboardInterrupt
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise


def resolve_model(name: str, search_paths: List[str]) -> Optional[str]:
    """First non-empty file named ``name`` in the registered search paths."""
    for sp in search_paths:
        p = os.path.join(sp, name)
        try:
            if os.path.isfile(p) and os.path.getsize(p) > 0:
                return p
        except OSError:
            continue
    return None


def download_model(name: str, models_dir: str, *,
                   search_paths: Optional[List[str]] = None,
                   model_urls: Dict[str, str] = MODEL_URLS,
                   fetch: Optional[Callable[[str, str], None]] = None) -> str:
    """Locate or download a weight file; returns the local path.  ``fetch``
    defaults to the module's ``_default_fetch``, read at the call."""
    found = resolve_model(name, (search_paths or []) + [models_dir])
    if found:
        return found
    url = model_urls.get(name)
    if not url:
        raise AssetError(f"unknown model name: {name}")
    return _atomic_download(url, os.path.join(models_dir, name), fetch or _default_fetch)


def ensure_sd21_configs(base_dir: str, *,
                        manifest: List[str] = SD21_CONFIG_MANIFEST,
                        base_url: str = SD21_CONFIG_BASE,
                        fetch: Optional[Callable[[str, str], None]] = None,
                        strict: bool = False) -> str:
    """Ensure the SD2.1 config set exists under base_dir; download missing
    files.  Per-file failures are warnings unless ``strict`` (reference
    behavior: non-fatal, sdmatte_nodes.py:98-99)."""
    os.makedirs(base_dir, exist_ok=True)
    for rel in manifest:
        target = os.path.join(base_dir, rel)
        if os.path.isfile(target):
            continue
        try:
            _atomic_download(f"{base_url}/{rel}", target, fetch or _default_fetch)
        except BaseException as e:
            if strict or isinstance(e, KeyboardInterrupt):
                raise
            print(f"[sdmatte_tpu_torch] warning: failed to fetch {rel}: {e}")
    return base_dir


def local_copy_fetch(src_root: str) -> Callable[[str, str], None]:
    """Test helper: a fetch() that copies from a local directory tree instead
    of the network (mirrors the URL's path suffix)."""
    def fetch(url: str, dst: str) -> None:
        rel = url.split("/resolve/main/")[-1] if "/resolve/main/" in url \
            else os.path.basename(url)
        src = os.path.join(src_root, rel)
        if not os.path.isfile(src):
            raise AssetError(f"missing local asset {src}")
        shutil.copyfile(src, dst)
    return fetch
