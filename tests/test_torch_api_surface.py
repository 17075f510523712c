"""The port's public names against the JAX package's, and the port's
package directory loaded the way ComfyUI loads a custom node.

Each subpackage of the port exports every name that the JAX package's
``__init__.py`` of the same subpackage binds, as the port's own objects, so
that swapping ``sdmatte_tpu`` for ``sdmatte_tpu_torch`` in an import works.
ComfyUI imports a custom node's ``__init__.py`` under a module name of its
own choosing and reads ``NODE_CLASS_MAPPINGS``; the port's package, loaded
so in a fresh process, registers the port's ``SDMatteApply`` and pulls in
neither jax nor the JAX package.
"""

import ast
import importlib
import inspect
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PACKAGE = ROOT / "sdmatte_tpu"
PACKAGE = ROOT / "sdmatte_tpu_torch"

# names the JAX package exports that the port has no counterpart of, with why
EXCLUDED = {
    ("checkpoint", "torch_key_to_path"):
        "maps a torch key to a path in the JAX param tree; the port loads by "
        "state_dict key into the module and has no param tree",
    ("utils", "timed"):
        "read the host clock without a synchronize, so it timed the enqueue of device "
        "work; the span recorder (utils/observability.span) stamps on the profiler's "
        "clock instead",
}


def _exported(init: pathlib.Path) -> list:
    """The names an ``__init__.py`` binds by its imports."""
    names = []
    for stmt in ast.parse(init.read_text()).body:
        if isinstance(stmt, (ast.Import, ast.ImportFrom)):
            names += [a.asname or a.name for a in stmt.names]
    return names


SUBPACKAGES = sorted(p.parent.name for p in JAX_PACKAGE.glob("*/__init__.py")
                     if _exported(p))


def test_every_subpackage_is_checked():
    assert {"api", "checkpoint", "core", "models", "ops", "parallel"} <= set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    port = importlib.import_module(f"sdmatte_tpu_torch.{sub}")
    for name in _exported(JAX_PACKAGE / sub / "__init__.py"):
        if (sub, name) in EXCLUDED:
            assert not hasattr(port, name)
            continue
        assert hasattr(port, name), f"sdmatte_tpu_torch.{sub} lacks {name}"
        obj = getattr(port, name)
        owner = obj.__name__ if inspect.ismodule(obj) else getattr(obj, "__module__", None)
        if owner is not None:        # a module, function or class: the port's own
            assert owner.startswith("sdmatte_tpu_torch."), (name, owner)


def test_node_names_from_the_api_and_the_package():
    import sdmatte_tpu_torch
    from sdmatte_tpu.api import NODE_DISPLAY_NAME_MAPPINGS as JAX_DISPLAY
    from sdmatte_tpu_torch.api import (NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS,
                                       SDMatteApply)
    from sdmatte_tpu_torch.api import node
    assert NODE_CLASS_MAPPINGS == {"SDMatteApply": SDMatteApply}
    assert SDMatteApply is node.SDMatteApply
    assert NODE_DISPLAY_NAME_MAPPINGS == JAX_DISPLAY
    assert sdmatte_tpu_torch.NODE_CLASS_MAPPINGS is NODE_CLASS_MAPPINGS
    assert sdmatte_tpu_torch.NODE_DISPLAY_NAME_MAPPINGS is NODE_DISPLAY_NAME_MAPPINGS
    # a host's probes for optional names (ComfyUI asks for WEB_DIRECTORY)
    assert not hasattr(sdmatte_tpu_torch, "WEB_DIRECTORY")


def _run(code, cwd=ROOT, timeout=180):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, cwd=cwd, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_import_alone_loads_and_builds_nothing():
    got = _run("""
        import json, sys
        import sdmatte_tpu_torch
        before = sorted(m for m in sys.modules if m.startswith("sdmatte_tpu_torch."))
        mappings = sdmatte_tpu_torch.NODE_CLASS_MAPPINGS
        from sdmatte_tpu_torch.ops import _build
        print(json.dumps({
            "submodules_before": before,
            "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "sdmatte_tpu")),
            "libraries": len(_build._LIBS),
            "launches": sum(k.launches for k in _build.Kernel.registry),
            "kernels": len(_build.Kernel.registry),
            "node": sorted(mappings)}))
        """)
    assert got["submodules_before"] == []
    assert got["jax"] == []
    assert (got["libraries"], got["launches"]) == (0, 0) and got["kernels"] >= 4
    assert got["node"] == ["SDMatteApply"]


def test_every_module_imports_first():
    """Each module of the port imports on its own, first, with no other
    module of the port loaded: the subpackages' imports form no cycle."""
    got = _run(f"""
        import importlib, json, sys
        done = []
        for m in {_module_names()!r}:
            for k in [k for k in sys.modules if k.split(".")[0] == "sdmatte_tpu_torch"]:
                del sys.modules[k]
            importlib.import_module(m)
            done.append(m)
        print(json.dumps(done))
        """)
    assert got == _module_names()


def _module_names():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


# ComfyUI's loader (nodes.py, load_custom_node): the package's __init__.py
# under a module name of the host's choosing, entered in sys.modules before
# it runs.  Host modules are stubs: folder_paths with a models directory, and
# comfy.model_management whose device is the CPU (a --cpu launch).  Then the
# bundled workflow, at inference size 64, runs through the port's runner
# under the same foreign name, its node on a tiny random pipeline.
COMFY_LOAD = """
    import importlib, importlib.util, inspect, json, os, sys, types
    import torch
    root, models, out_dir = sys.argv[1:4]
    name = "custom_node_sdmatte_port"

    fp = types.ModuleType("folder_paths")
    fp.models_dir = models
    fp.folder_names_and_paths = {}
    def add_model_folder_path(kind, path, is_default=False):
        paths = fp.folder_names_and_paths.setdefault(kind, [])
        if path not in paths:
            paths.append(path)
    fp.add_model_folder_path = add_model_folder_path
    fp.get_folder_paths = lambda kind: list(fp.folder_names_and_paths.get(kind, []))
    comfy = types.ModuleType("comfy")
    mm = types.ModuleType("comfy.model_management")
    mm.get_torch_device = lambda: torch.device("cpu")
    mm.soft_empty_cache = lambda force=False: None
    comfy.model_management = mm
    sys.modules.update({"folder_paths": fp, "comfy": comfy, "comfy.model_management": mm})

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "sdmatte_tpu_torch", "__init__.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    cls = getattr(module, "NODE_CLASS_MAPPINGS")["SDMatteApply"]

    wf = importlib.import_module(name + ".workflow")
    node = sys.modules[name + ".api.node"]
    cli = importlib.import_module(name + ".cli")
    cfg_mod = importlib.import_module(name + ".configs")
    dtypes = importlib.import_module(name + ".core.dtypes")
    pipe = cli.random_pipeline(cfg_mod.SDMatteConfig.tiny(), device=torch.device("cpu"),
                               policy=dtypes.FP32, impl="plain")
    asked = []
    def get_pipeline(ckpt, **kw):
        asked.append(kw)
        return pipe
    node.get_pipeline = get_pipeline
    with open(os.path.join(root, "examples", "workflow_sdmatte_tpu.json")) as f:
        graph = json.load(f)
    for n in graph["nodes"]:
        if n["type"] == "SDMatteApply":
            n["widgets_values"][1] = 64
    registry = dict(wf.builtin_nodes(os.path.join(root, "examples"), out_dir),
                    SDMatteApply=cls())
    with torch.inference_mode():
        results = wf.execute_workflow(graph, registry, verbose=False)
    alpha = results[3][0]
    print(json.dumps({
        "class_file": inspect.getfile(cls),
        "class_module": cls.__module__,
        "is_port_node": cls is node.SDMatteApply,
        "foreign": sorted(m for m in sys.modules if m.split(".")[0] in
                          ("jax", "sdmatte_tpu", "sdmatte_tpu_torch", "run_workflow")),
        "sdmatte_folder": fp.get_folder_paths("SDMatte"),
        "force_cpu": [kw.get("force_cpu") for kw in asked],
        "alpha": list(alpha.shape), "finite": bool(torch.isfinite(alpha).all()),
        "pngs": sorted(os.listdir(out_dir))}))
"""


def test_comfyui_style_load_registers_the_port_node(tmp_path):
    models, out = tmp_path / "models", tmp_path / "out"
    code = COMFY_LOAD.replace("sys.argv[1:4]", repr([str(ROOT), str(models), str(out)]))
    # run from a directory where neither package is importable by its own name
    got = _run(code, cwd=tmp_path)
    assert pathlib.Path(got["class_file"]) == PACKAGE / "api" / "node.py"
    assert got["class_module"] == "custom_node_sdmatte_port.api.node"
    assert got["is_port_node"]
    assert got["foreign"] == []
    # the node registered its model folder with the host's path registry
    assert got["sdmatte_folder"] == [str(models / "SDMatte")]
    # a host whose device is the CPU runs the node there
    assert got["force_cpu"] == [True]
    assert got["alpha"] == [1, 768, 1024] and got["finite"]
    assert got["pngs"] == ["preview_01_000.png", "sdmatte_matted_01_000.png"]
