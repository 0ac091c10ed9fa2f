"""Every module of the benchmark imports with JAX and the JAX package
blocked (top-level names compared whole: ``repro_torch`` is not ``repro``),
and the reference also with the program (``repro_torch``) blocked."""
import subprocess
import sys

import pytest

from bench.tests import smoke

BLOCKER = """
import importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[2] + "/src", sys.argv[2]]
import importlib
for mod in sys.argv[3].split(","):
    importlib.import_module(mod)
print("imported", len(sys.argv[3].split(",")))
"""


def _modules(sub: str) -> list[str]:
    base = smoke.ROOT / "bench"
    out = []
    for p in sorted((base / sub).rglob("*.py")):
        rel = p.relative_to(smoke.ROOT).with_suffix("")
        if "tests" in rel.parts or "." in p.stem:
            continue
        out.append(".".join(rel.parts).removesuffix(".__init__"))
    return out


@pytest.mark.parametrize("sub,blocked", [
    ("", "jax,jaxlib,flax,repro"),
    ("reference", "jax,jaxlib,flax,repro,repro_torch"),
])
def test_modules_import_with_blocked_packages(sub, blocked):
    mods = _modules(sub)
    assert mods
    proc = subprocess.run([sys.executable, "-c", BLOCKER, blocked, str(smoke.ROOT),
                           ",".join(mods)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    from bench import harness

    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "repro_torch.x", sys.modules["json"])
    assert harness.forbidden_modules() == []


@pytest.fixture
def reader_loading_jax(tmp_path, monkeypatch):
    """Every metric reader imports a stub module named ``jax`` first."""
    from bench import harness

    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("STUB = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    real = harness.reader

    def reader(name):
        read, phase = real(name)

        def loading(run, ph):
            __import__("jax")
            return read(run, ph)

        return loading, phase

    monkeypatch.setattr(harness, "reader", reader)
    had = sys.modules.get("jax")
    yield
    if had is None:
        sys.modules.pop("jax", None)


def test_a_reader_that_loads_jax_after_the_window_gives_no_result(reader_loading_jax, tmp_path,
                                                                   monkeypatch, capsys):
    import bench.run as run_py
    from bench import harness

    cell = "mamba2_370m.train_4k"
    real = harness.run_cell

    def on_the_cpu(spec, c, **kw):
        kw.update(device="cpu", seconds=0.0,
                  conf_file=smoke.smoke_conf(c["config"], tmp_path),
                  mix_override=dict(smoke.MIX["train"], **smoke.CELL[cell]))
        return real(spec, c, **kw)

    monkeypatch.setattr(harness, "device_problem", lambda chips: None)
    monkeypatch.setattr(harness, "run_cell", on_the_cpu)
    rc = run_py.main(["--workload", cell, "--seed", "7", "--seconds", "0", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 1
    assert "jax" in sys.modules and not out.strip()
    assert "loaded jax" in err
