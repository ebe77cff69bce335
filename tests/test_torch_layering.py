"""The port's layers, read from its source with ``ast``: what ``models/``
modules share is public, ``kernels/`` stands below ``models/``, and the
import graph among ``models/`` modules has no cycle. Imports made inside
functions count as much as those at module level."""

import ast
import os

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PKG = "sifsr_tpu_torch"


def _modules() -> dict:
    """Dotted module name -> path, for every module of the package."""
    out = {}
    base = os.path.join(ROOT, PKG)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3].split(os.sep)
                if rel[-1] == "__init__":
                    rel = rel[:-1]
                out[".".join(rel)] = os.path.join(dirpath, f)
    return out


MODULES = _modules()


def _imports(name: str) -> list:
    """(imported module, imported name or None, line) for every import in
    module ``name``, anywhere in it; ``from package import module`` counts
    as an import of the module, and ``module._name`` on a module bound by
    an import as an import of ``_name``."""
    path = MODULES[name]
    tree = ast.parse(open(path).read(), path)
    package = name if path.endswith("__init__.py") else name.rpartition(".")[0]
    out = []
    bound = {}                                   # local name -> module it binds
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out.append((a.name, None, node.lineno))
                if a.asname:
                    bound[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                parts = package.split(".")[:len(package.split(".")) - node.level + 1]
                mod = ".".join(parts + ([mod] if mod else []))
            for a in node.names:
                sub = f"{mod}.{a.name}"
                if sub in MODULES:
                    out.append((sub, None, node.lineno))
                    bound[a.asname or a.name] = sub
                else:
                    out.append((mod, a.name, node.lineno))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id in bound and node.attr.startswith("_")
                and not node.attr.startswith("__")):
            out.append((bound[node.value.id], node.attr, node.lineno))
    return out


def _in(layer: str, name: str) -> bool:
    return name == f"{PKG}.{layer}" or name.startswith(f"{PKG}.{layer}.")


def _private_imports_across_models() -> list:
    return [f"{m}:{line} imports {target}.{what}"
            for m in MODULES if _in("models", m)
            for target, what, line in _imports(m)
            if _in("models", target) and target != m and what and what.startswith("_")]


def _kernels_importing_models() -> list:
    return [f"{m}:{line} imports {target}"
            for m in MODULES if _in("kernels", m)
            for target, _, line in _imports(m) if _in("models", target)]


def _cycles_among_models() -> list:
    """The strongly connected components of more than one module (and
    self-loops) of the import graph among ``models/`` modules."""
    nodes = [m for m in MODULES if _in("models", m) and m != f"{PKG}.models"]
    edges = {m: sorted({t for t, _, _ in _imports(m) if t in nodes}) for m in nodes}
    index, low, stack, on_stack, found = {}, {}, [], set(), []

    def visit(v):
        index[v] = low[v] = len(index)
        stack.append(v)
        on_stack.add(v)
        for w in edges[v]:
            if w not in index:
                visit(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1 or v in edges[v]:
                found.append(" <-> ".join(sorted(comp)))

    for v in nodes:
        if v not in index:
            visit(v)
    return found


RULES = {
    "no_private_imports_across_models": _private_imports_across_models,
    "no_kernels_to_models_import": _kernels_importing_models,
    "no_import_cycle_among_models": _cycles_among_models,
}


def test_the_walk_sees_the_serving_modules():
    """The rules read the modules they are about, and the reader sees a
    function-level import."""
    for m in ("models.int8_serving", "models.quantized_packed", "models.packed",
              "models.quantized", "kernels.conv_px", "kernels.conv_i8"):
        assert f"{PKG}.{m}" in MODULES, m
    serving = {t for t, _, _ in _imports(f"{PKG}.models.int8_serving")}
    assert {f"{PKG}.models.packed", f"{PKG}.models.quantized"} <= serving
    probe = {t for t, _, _ in _imports(f"{PKG}.cli.predict")}
    assert f"{PKG}.models.int8_serving" in probe          # imported inside a function


@pytest.mark.parametrize("rule", sorted(RULES))
def test_layering(rule):
    assert RULES[rule]() == []
