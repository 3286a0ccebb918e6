"""Nothing under ``benchmark/`` imports JAX or the JAX package, top-level
names compared whole (``ctrl_adapter_tpu_torch`` begins with
``ctrl_adapter_tpu``), and the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from harness.env import JAX_MODULES
from harness.manifest import BENCH_DIR, ROOT


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    return glob.glob(os.path.join(BENCH_DIR, sub, "**", "*.py"), recursive=True)


def test_no_jax_anywhere():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(JAX_MODULES), (path, tops & set(JAX_MODULES))


def test_reference_takes_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "ctrl_adapter_tpu_torch" not in tops, path


def test_whole_names_are_compared(monkeypatch):
    import types

    from harness.env import jax_loaded

    monkeypatch.setitem(sys.modules, "ctrl_adapter_tpu_torch.probe", types.ModuleType("p"))
    assert "ctrl_adapter_tpu" not in jax_loaded()
    monkeypatch.setitem(sys.modules, "ctrl_adapter_tpu.probe", types.ModuleType("p"))
    assert "ctrl_adapter_tpu" in jax_loaded()


def test_a_run_loads_no_jax():
    """A process that imports the harness, every mode and family, the reference
    and the program's pipelines holds no JAX module."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import env, manifest, profile, flops, compare\n"
            "from harness.manifest import load_cell\n"
            "for w in ('svd_depth.generate', 'i2vgenxl_depth.generate', 'svd_depth.train'):\n"
            "    c = load_cell(w); c.family(); c.mode(); c.readers()\n"
            "manifest.kernel_ops()\n"
            "import reference.svd_pipeline, reference.i2vgenxl_pipeline, reference.precision\n"
            "import ctrl_adapter_tpu_torch.pipelines.svd\n"
            "import ctrl_adapter_tpu_torch.pipelines.i2vgenxl\n"
            "import ctrl_adapter_tpu_torch.train.trainer\n"
            "print(','.join(env.jax_loaded()))\n") % (BENCH_DIR, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "USE_FLAX": "0"}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "", out.stdout
