"""The port stands alone: every ``repro_torch`` module (and
``chip_smoke.py``) imports with JAX made unimportable, no source line
imports the JAX package, and the package never calls PyTorch's fused
attention (``chip_smoke.py`` only times it as a yardstick)."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")

_BLOCKED = r'''
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print(len(names))
'''


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, REPO], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_no_source_line_imports_the_reference():
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)")
    for path in _sources():
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                assert not bad.match(line), f"{path}:{n}: {line.strip()}"


def test_port_never_calls_the_library_attention():
    for path in _sources():
        if path.endswith("chip_smoke.py"):
            continue
        with open(path) as fh:
            assert "scaled_dot_product_attention" not in fh.read(), path
