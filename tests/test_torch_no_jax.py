"""ctts_tpu_torch must import on a machine without JAX or ctts_tpu.

A fresh interpreter imports every module of the package (the serving
loop, ctts_tpu_torch.parallel.batch, among them), chip_smoke.py and the
port's tools (tools/torch_*.py), and neither jax nor any module of the
JAX package (ctts_tpu, ctts_tpu.*) may have been loaded by any of them."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, importlib.machinery, pkgutil, sys
import ctts_tpu_torch
# runtime/ also holds the libraries make builds there (libctts*.so),
# which the walk reports as extension modules: they are not Python
# modules, and ctypes loads them.
names = [m.name for m in pkgutil.walk_packages(ctts_tpu_torch.__path__,
                                               "ctts_tpu_torch.")
         if not isinstance(m.module_finder.find_spec(m.name).loader,
                           importlib.machinery.ExtensionFileLoader)]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
assert "ctts_tpu_torch.parallel.batch" in names
assert "ctts_tpu_torch.runtime.native" in names
assert "ctts_tpu_torch.ops.hopper.silence" in names
assert "ctts_tpu_torch.ops.hopper.contour" in names
assert "ctts_tpu_torch.ops.hopper.region_post" in names
assert "ctts_tpu_torch.ops.hopper.pack_encode" in names
assert "ctts_tpu_torch.ops.hopper.units" in names
# runtime/__init__.py re-exports the native binding, as the JAX
# package's runtime/__init__.py does.
from ctts_tpu_torch.runtime import NativeEngine, native_available
from ctts_tpu_torch.runtime.native import NativeEngine as engine
assert NativeEngine is engine and callable(native_available)
import glob, importlib.util, os
tools = sorted(glob.glob(os.path.join("tools", "torch_*.py")))
assert "tools/torch_profile_stages.py" in tools, tools
assert "tools/torch_generate_samples.py" in tools, tools
for path in tools:
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
jax_pkg = sorted(m for m in sys.modules
                 if m == "ctts_tpu" or m.startswith("ctts_tpu."))
assert not jax_pkg, jax_pkg
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 56    # every module was reached
