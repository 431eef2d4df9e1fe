"""The port stands alone: every module of polykey_tpu_torch, and
chip_smoke.py, imports with JAX, Flax and the JAX package made
unimportable (in a fresh interpreter, so this test process's own JAX
imports cannot mask a leak)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys

sys.modules["jax"] = None
BLOCKED = ("jax", "flax", "polykey_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import polykey_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    polykey_tpu_torch.__path__, "polykey_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m and any(
    m == b or m.startswith(b + ".") for b in BLOCKED) and sys.modules[m] is not None]
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_no_jax_and_nothing_of_the_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20
