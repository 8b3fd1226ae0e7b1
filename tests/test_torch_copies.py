"""The port's copies of the reference's framework-free modules stay copies.

For every module under ``src/repro/`` whose source imports no ``jax``
and which has a file at the same relative path under
``src/repro_torch/``, the two parse to the same tree once docstrings
(module, class, function) are stripped and ``repro_torch`` imports are
read as ``repro`` imports.  So a copy differs from the reference in its
imports and docstrings alone; anything else is drift.

The simulator, its CLI and the sweep (``repro.core.simulator``,
``repro.launch.simulate``, ``repro.explore``) must be in the port whole:
every module of their import closure, computed from the reference's
import statements (those inside functions included), has its copy.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = ROOT / "repro", ROOT / "repro_torch"

#: package ``__init__`` files of packages that the port implements rather
#: than copies, each with the reason its text differs
NOT_COPIES = {
    "kernels/flash_attention/__init__.py":
        "re-exports the reference's ops and ref; the port's plain "
        "version lives in its ops module and it has no ref module",
    "kernels/paged_attention/__init__.py":
        "re-exports the reference's ops and ref; the port's plain "
        "version lives in its ops module and it has no ref module",
    "kernels/ssd_scan/__init__.py":
        "re-exports the reference's ops and ref; the port's plain "
        "version lives in its ops module and it has no ref module",
    "serving/__init__.py":
        "re-exports the reference's JAX engine; the port's engine is "
        "its own implementation and the package re-exports nothing",
}
CLOSURE_ROOTS = ("repro.core.simulator", "repro.launch.simulate",
                 "repro.explore")


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _imports_jax(path):
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        if any(n.split(".")[0] in ("jax", "jaxlib") for n in names):
            return True
    return False


def _as_reference(name):
    if name.split(".")[0] == "repro_torch":
        return "repro" + name[len("repro_torch"):]
    return name


def _normalized(path):
    """ast.dump of ``path`` without docstrings, repro_torch read as repro."""
    tree = _tree(path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
        elif isinstance(node, ast.ImportFrom) and node.module:
            node.module = _as_reference(node.module)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                alias.name = _as_reference(alias.name)
    return ast.dump(tree)


def _module_file(name):
    base = ROOT / name.replace(".", "/")
    for path in (base.with_suffix(".py"), base / "__init__.py"):
        if path.exists():
            return path
    return None


def _closure(roots):
    """Reference modules reached from ``roots`` through import statements
    anywhere in a module (``from pkg import name`` counts ``pkg.name``
    when that is a module), with the packages that hold them."""
    seen, todo = {}, list(roots)
    while todo:
        name = todo.pop()
        if name in seen or name.split(".")[0] != "repro":
            continue
        path = _module_file(name)
        if path is None:
            continue
        seen[name] = path
        parts = name.split(".")
        todo += [".".join(parts[:i]) for i in range(2, len(parts))]
        for node in ast.walk(_tree(path)):
            if isinstance(node, ast.Import):
                todo += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                todo.append(node.module)
                todo += [f"{node.module}.{a.name}" for a in node.names]
    return seen


COPIES = sorted(
    str(p.relative_to(REF)) for p in REF.rglob("*.py")
    if (PORT / p.relative_to(REF)).exists() and not _imports_jax(p))


def test_the_exceptions_are_package_inits_the_port_has():
    for rel in NOT_COPIES:
        assert rel in COPIES and rel.endswith("__init__.py"), rel


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    if rel in NOT_COPIES:
        assert _normalized(REF / rel) != _normalized(PORT / rel), \
            f"{rel} is a copy now: take it off NOT_COPIES"
        return
    assert _normalized(PORT / rel) == _normalized(REF / rel), (
        f"src/repro_torch/{rel} differs from src/repro/{rel} beyond "
        "docstrings and the repro_torch imports")


def test_simulator_closure_is_ported_whole():
    closure = _closure(CLOSURE_ROOTS)
    assert {"repro.core.simulator", "repro.core.worker", "repro.obs.trace",
            "repro.explore.sweep", "repro.configs.zamba2_2_7b"} <= \
        set(closure)
    missing = [str(p.relative_to(REF)) for p in closure.values()
               if not (PORT / p.relative_to(REF)).exists()]
    assert not missing, f"not in src/repro_torch/: {missing}"
    assert not [p for p in closure.values() if _imports_jax(p)]
