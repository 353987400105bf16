"""Every public top-level name of a reference module is in its port
counterpart, or is named in the port module's docstring as left out
(ROADMAP item 14).  Names are read from the sources (functions, classes,
assignments, and an ``__init__``'s re-exports), so nothing is imported;
every reference module has a port file."""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = (os.path.join(ROOT, "src", p) for p in ("repro", "repro_torch"))


def _modules():
    out = []
    for root, _, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(root, f), REF)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _public_names(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for e in [t] if isinstance(t, ast.Name) else \
                        getattr(t, "elts", []):
                    if isinstance(e, ast.Name):
                        names.add(e.id)
        elif isinstance(node, ast.ImportFrom) and path.endswith(
                "__init__.py"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}, \
        ast.get_docstring(tree) or ""


def test_every_reference_module_has_a_port_file():
    missing = [m for m in _modules()
               if not os.path.exists(os.path.join(PORT, m))]
    assert not missing, missing


@pytest.mark.parametrize("module", _modules())
def test_public_names_are_ported_or_documented(module):
    ref_names, _ = _public_names(os.path.join(REF, module))
    port_names, doc = _public_names(os.path.join(PORT, module))
    undocumented = sorted(
        n for n in ref_names - port_names
        if not re.search(r"`+" + re.escape(n) + r"`+", doc))
    assert not undocumented, (module, undocumented)
