"""psac_tpu_torch imports torch only: no JAX, no psac_tpu, no Triton."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import psac_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(psac_tpu_torch.__path__,
                                               "psac_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "psac_tpu", "triton"))
assert not bad, bad
print(len(mods))
"""


@pytest.mark.parametrize("entry", ["package", "every_module"])
def test_imports_without_jax(entry):
    code = "import psac_tpu_torch, sys\nassert 'jax' not in sys.modules" \
        if entry == "package" else _CHECK
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if entry == "every_module":
        assert int(out.stdout) >= 15


def test_sources_never_import_jax():
    """No module of the port names jax or psac_tpu in an import."""
    pkg = os.path.join(ROOT, "psac_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                for line in fh:
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        mod = s.split()[1]
                        assert mod.split(".")[0] not in ("jax", "psac_tpu"), \
                            (f, s)
