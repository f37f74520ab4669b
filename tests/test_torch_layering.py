"""The port's import graph, read from its source with ``ast``:

    experiments, eval, parallel, port_bench (callers)
            |
    core.trainer --> ops.mcpc_chain --> ops/csrc kernels
            |               |
            v               v
    core.model, core.modules, core.optim, core.engine
            |
            v
    utils: imports nothing of the package at run time

``core.trainer`` reaches ``ops`` only inside its functions: ``ops``' coverage
rule reads core's module classes, the one cycle the layout keeps.  ``eval``
reaches ``ops`` by one edge, ``eval/inception.py`` -> ``ops.inception_conv``
(InceptionV3's convolution kernel).  Imports under ``typing.TYPE_CHECKING``
are annotations and do not count.
"""

import ast
import pathlib

import pytest

PKG = "montecarlopredictivecoding_tpu_torch"
ROOT = pathlib.Path(__file__).resolve().parents[1] / PKG


def _module_name(path: pathlib.Path) -> str:
    parts = list(path.relative_to(ROOT.parent).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _is_type_checking(node: ast.If) -> bool:
    t = node.test
    return (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or (
        isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING")


def _imports(path: pathlib.Path):
    """``(imported module, inside a function)`` for each import of the
    package in ``path`` that runs, relative imports resolved."""
    name = _module_name(path)
    package = name if path.name == "__init__.py" else name.rpartition(".")[0]
    return _imports_of(path.read_text(), package)


def _imports_of(source: str, package: str):
    found = []

    def visit(node, in_fn):
        if isinstance(node, ast.If) and _is_type_checking(node):
            for child in node.orelse:
                visit(child, in_fn)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            in_fn = True
        if isinstance(node, ast.Import):
            found.extend((a.name, in_fn) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")
                base = base[: len(base) - node.level + 1]
                target = ".".join(base + ([node.module] if node.module else []))
            else:
                target = node.module or ""
            if node.module is None or target == package:
                # ``from . import x``: the names are modules
                found.extend((f"{target}.{a.name}", in_fn) for a in node.names)
            else:
                found.append((target, in_fn))
        for child in ast.iter_child_nodes(node):
            visit(child, in_fn)

    visit(ast.parse(source), False)
    return [(m, f) for m, f in found if m == PKG or m.startswith(PKG + ".")]


def _modules(sub: str):
    return sorted((ROOT / sub).rglob("*.py")) if sub else sorted(ROOT.rglob("*.py"))


def _layer(module: str) -> str:
    return module.split(".")[1] if module.count(".") else ""


def _breaks(sub: str, allowed):
    """The imports under ``sub`` that ``allowed(file, module, in_fn)``
    refuses (``file`` relative to the package)."""
    found = []
    for p in _modules(sub):
        f = str(p.relative_to(ROOT))
        found += [(f, m, in_fn) for m, in_fn in _imports(p) if not allowed(f, m, in_fn)]
    return found


# the one edge from eval to ops: the FID extractor's convolution kernel
EVAL_TO_OPS = ("eval/inception.py", f"{PKG}.ops.inception_conv")

RULES = {
    # the leaf: observability, checkpoint, convert, precision
    "utils_imports_nothing_of_the_package": (
        "utils", lambda f, m, in_fn: _layer(m) == "utils"),
    "models_do_not_import_ops": ("models", lambda f, m, in_fn: _layer(m) != "ops"),
    "eval_does_not_import_ops": ("eval", lambda f, m, in_fn: _layer(m) != "ops"
                                 or (f, m) == EVAL_TO_OPS),
    # core reaches ops only from inside the trainer's functions
    "core_imports_core_and_utils": (
        "core", lambda f, m, in_fn: _layer(m) in ("core", "utils")
        or (_layer(m) == "ops" and in_fn)),
    "ops_imports_no_caller": (
        "ops", lambda f, m, in_fn: _layer(m) in ("ops", "utils")
        or (_layer(m) == "core" and m != f"{PKG}.core.trainer")),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_layering(rule):
    sub, allowed = RULES[rule]
    assert _modules(sub)
    assert _breaks(sub, allowed) == []


def test_eval_reaches_ops_by_the_one_edge():
    """The eval rule lets through ``eval/inception.py`` importing
    ``ops.inception_conv`` and nothing else of ``ops``: the edge is there,
    and the same import from another eval file, or another ops module from
    ``eval/inception.py``, breaks the rule."""
    _, allowed = RULES["eval_does_not_import_ops"]
    assert (EVAL_TO_OPS[1], False) in _imports(ROOT / EVAL_TO_OPS[0])
    assert [(f, m) for f, m, _ in _breaks("eval", lambda f, m, in_fn: _layer(m) != "ops")] == [
        EVAL_TO_OPS]
    assert not allowed("eval/fid.py", EVAL_TO_OPS[1], False)
    assert not allowed(EVAL_TO_OPS[0], f"{PKG}.ops.mcpc_chain", False)
    assert not allowed(EVAL_TO_OPS[0], f"{PKG}.ops", False)


def test_core_model_imports_at_module_level():
    imports = _imports(ROOT / "core" / "model.py")
    assert imports and not [m for m, in_fn in imports if in_fn]


def test_the_coverage_rule_has_one_definition():
    """``_CANONICAL_KINDS`` is assigned in ``ops/mcpc_chain.py`` only, and the
    trainer takes the rule from there."""
    owners = []
    for p in _modules(""):
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_CANONICAL_KINDS" for t in node.targets):
                owners.append(str(p.relative_to(ROOT)))
    assert owners == ["ops/mcpc_chain.py"]
    src = (ROOT / "core" / "trainer.py").read_text()
    assert all(f in src for f in ("model_activation(", "supports_model(", "output_pc_var("))


def test_the_resolver_sees_each_import_form():
    """A check that fails on nothing proves nothing: the resolver finds the
    forms the rules rely on, and skips annotations and other packages."""
    source = """
import typing as tp
import torch
from . import losses as L
from .model import PCModel
from ..utils.observability import span
from montecarlopredictivecoding_tpu_torch.eval import metrics
if tp.TYPE_CHECKING:
    from ..models.dlgm import Dlgm
else:
    from ..data import mnist

def f():
    from ..ops.mcpc_chain import mcpc_chain
"""
    assert _imports_of(source, f"{PKG}.core") == [
        (f"{PKG}.core.losses", False), (f"{PKG}.core.model", False),
        (f"{PKG}.utils.observability", False), (f"{PKG}.eval", False),
        (f"{PKG}.data", False), (f"{PKG}.ops.mcpc_chain", True)]
