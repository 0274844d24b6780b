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


_GSA_CHECK = r"""
import os, shutil, sys
assert shutil.which("nvcc") is None or os.environ.get("PSAC_ALLOW_NVCC")
import psac_tpu_torch
from psac_tpu_torch import build_gsa, build_gst, DeviceGSA
from psac_tpu_torch.models import gsa
from psac_tpu_torch.ops import cuda_lib, rmq
from psac_tpu_torch.verify import gsa_oracle
assert rmq.rmq_resolve.launches == 0 and cuda_lib._lib is None
assert {"psac_rmq_resolve_i32", "psac_rmq_resolve_i64"} <= set(
    cuda_lib._SIGNATURES)
assert os.path.exists(os.path.join(cuda_lib.CSRC_DIR, "rmq_resolve.cu"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "psac_tpu", "triton"))
assert not bad, bad
"""


@pytest.mark.parametrize("entry", ["package", "every_module", "gsa_modules"])
def test_imports_without_jax(entry):
    code = {"package": "import psac_tpu_torch, sys\n"
                       "assert 'jax' not in sys.modules",
            "every_module": _CHECK, "gsa_modules": _GSA_CHECK}[entry]
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
