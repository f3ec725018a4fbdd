"""The port stands alone: no module of ``close_kmers_tpu_torch``, and not
``chip_smoke.py``, imports ``jax`` or anything of the JAX package
``close_kmers_tpu``.

The first case imports every module of the port in a fresh interpreter
whose import system refuses those names; the second reads each source
with ``ast`` and finds no such import, also where it is made inside a
function: an import that runs only when a function is called escapes
the first case.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "close_kmers_tpu_torch")

_REFUSE = r'''
import importlib.abc, pkgutil, sys

def refused(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "close_kmers_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import close_kmers_tpu_torch as pkg
names = [pkg.__name__]
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    __import__(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules if refused(n))
assert not bad, bad
print(len(names))
'''


def test_every_module_imports_with_jax_refused():
    env = {k: v for k, v in os.environ.items()
           if k != "CLOSE_KMERS_JAX_PLATFORM"}
    p = subprocess.run([sys.executable, "-c", _REFUSE], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    n = int(p.stdout.split()[-1])
    assert n == len(_port_sources()) + 1     # the sources plus the package


def _port_sources():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.relpath(os.path.join(root, f), REPO) for f in files
                if f.endswith(".py") and f != "__init__.py"
                or f == "__init__.py" and root != PKG]
    return sorted(out)


def _jax_imports(path):
    """Every import of jax or of the JAX package in the source at ``path``,
    wherever it stands (top level, function body, try block)."""
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names
                  if n.split(".")[0] in ("jax", "jaxlib", "close_kmers_tpu")]
    return found


@pytest.mark.parametrize("path", ["chip_smoke.py"] + _port_sources())
def test_source_names_no_jax_import(path):
    assert _jax_imports(path) == []
