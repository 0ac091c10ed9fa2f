"""Every module of the PyTorch port, chip_smoke.py, the port's scripts
(``scripts/torch_*.py``) and its examples (``examples/torch_*.py``) import
with JAX and the reference package blocked: the port carries its own copy
of whatever it needs from ``repro``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pathlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its phases run only under __main__
import runpy
scripts = sorted(pathlib.Path("scripts").glob("torch_*.py"))
examples = sorted(pathlib.Path("examples").glob("torch_*.py"))
for script in scripts + examples:
    runpy.run_path(str(script), run_name="imported")  # main() runs only as __main__
leaked = sorted(n for n, m in sys.modules.items()
                if m is not None and (n == "jax" or n.startswith(("jax.", "repro."))))
print(len(names), len(scripts), len(examples), leaked)
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, n_scripts, n_examples, leaked = out.stdout.split(maxsplit=3)
    # every module and script the port has (the serve tier's 4 modules,
    # torch_runtime_serve.py, the parallel substrate's 5 modules with
    # launch.mesh included, and launch.dryrun; the run report, the table and
    # the fixture scripts, and the five examples); one that drops out shows
    assert int(n_modules) >= 87
    assert int(n_scripts) >= 6
    assert int(n_examples) >= 5
    assert leaked.strip() == "[]"


def test_port_sources_never_name_jax_or_the_reference():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("torch_*.py"))
             + sorted((ROOT / "examples").glob("torch_*.py")))
    for path in files:
        for line in path.read_text().splitlines():
            code = line.split("#", 1)[0].strip()
            assert not code.startswith(("import jax", "from jax", "import repro ",
                                        "from repro.", "from repro import")), \
                f"{path.name}: {line}"
