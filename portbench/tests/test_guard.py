"""The import guard, and the reference's independence from the program,
each in a fresh process."""

import os
import subprocess
import sys

import pytest

from portbench.harness import guard

from conftest import REPO

REFS = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "portbench",
                                                      "reference"))
              if f.endswith(".py") and not f.startswith("_"))


def python(code: str, extra_path: str = "") -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (extra_path, REPO) if p))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=extra_path or REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_names_are_compared_whole():
    assert guard.forbidden_modules(["psac_tpu_torch", "psac_tpu_torch.ops",
                                    "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(["psac_tpu.models", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "psac_tpu"]


def test_guard_in_a_fresh_process(tmp_path):
    # a stand-in package named as the JAX package, loaded by the process
    (tmp_path / "psac_tpu").mkdir()
    (tmp_path / "psac_tpu" / "__init__.py").write_text("")
    code = ("import psac_tpu_torch.models.suffix_array\n"
            "from portbench.harness import guard\n"
            "print(guard.forbidden_modules())")
    assert python(code, str(tmp_path)) == "[]"
    assert python("import psac_tpu\n" + code, str(tmp_path)) == \
        "['psac_tpu']"


@pytest.mark.parametrize("name", REFS)
def test_reference_module_loads_nothing_of_the_program(name):
    code = (f"import sys\nimport portbench.reference.{name}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'psac_tpu', 'psac_tpu_torch'}))")
    assert python(code) == "[]"
