"""Import hygiene of the port: no JAX, no ``repro``, CUDA by default.

An AST scan of every module of ``src/repro_torch`` and of ``chip_smoke.py``
finds no import of ``jax``, ``repro``, the root ``benchmarks`` or the root
``tools`` (which drive ``repro``); every module imports without
``triton``; every parameter named ``device`` defaults to ``"cuda"``.
"""
import ast
import dataclasses
import importlib
import inspect
import pkgutil
from pathlib import Path

import pytest

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_repro_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "benchmarks", "tools"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_every_module_imports_and_defaults_to_cuda():
    assert len(MODULES) >= 20
    defaults = {}
    for name in MODULES:
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__", None) != name or not callable(obj):
                continue
            if dataclasses.is_dataclass(obj):
                for fld in dataclasses.fields(obj):
                    if fld.name == "device":
                        defaults[f"{name}.{attr}"] = fld.default
                continue
            try:
                params = inspect.signature(obj).parameters
            except (TypeError, ValueError):
                continue
            if "device" in params:
                defaults[f"{name}.{attr}"] = params["device"].default
    assert "repro_torch.core.api.Explainer" in defaults
    assert "repro_torch.models.cnn.init_params" in defaults
    assert {"repro_torch.train.classifier.eval_batch", "repro_torch.train.classifier.load_params",
            "repro_torch.data.images.synthetic_images"} <= set(defaults)
    assert {"repro_torch.examples.quickstart", "repro_torch.examples.train_lm", "repro_torch.tools.perf_iterate",
            "repro_torch.tools.make_golden", "repro_torch.tools.render_experiments"} <= set(MODULES)
    assert {"repro_torch.tools.make_golden.golden_inputs", "repro_torch.tools.make_golden.golden_result",
            "repro_torch.tools.perf_iterate.explain_adaptive_record"} <= set(defaults)
    assert {k: v for k, v in defaults.items() if v != "cuda"} == {}
