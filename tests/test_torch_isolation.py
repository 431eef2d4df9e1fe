"""The port stands alone: every module of polykey_tpu_torch (the prefix
cache, the KV wire format, quantized weights, the MoE layer, the
checkpoint loader, the speculative round, offline generation and the
serving shell — faults, the watchdog, the supervisor, obs/*, the secret
store, reflection and its protos — among them), and chip_smoke.py with
its shell phase, imports with
JAX, Flax, ml_dtypes, the JAX package, safetensors and orbax made
unimportable (in a fresh interpreter, so this test process's own JAX
imports cannot mask a leak)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys

sys.modules["jax"] = None
BLOCKED = ("jax", "flax", "ml_dtypes", "polykey_tpu", "safetensors", "orbax",
           "cryptography")

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
# The prefix cache, the host tier, the wire format, quantized weights, the
# MoE layer, the checkpoint loader, the speculative round (ragged too) and
# offline generation among them.
assert {"polykey_tpu_torch.engine.prefix_cache", "polykey_tpu_torch.engine.kv_cache",
        "polykey_tpu_torch.models.quant", "polykey_tpu_torch.ops.moe",
        "polykey_tpu_torch.models.loader", "polykey_tpu_torch.engine.spec_decode",
        "polykey_tpu_torch.models.generate",
        "polykey_tpu_torch.models.speculative",
        "polykey_tpu_torch.faults", "polykey_tpu_torch.engine.watchdog",
        "polykey_tpu_torch.engine.supervisor", "polykey_tpu_torch.obs.trace",
        "polykey_tpu_torch.obs.prometheus", "polykey_tpu_torch.obs.timeline",
        "polykey_tpu_torch.obs.exposition", "polykey_tpu_torch.obs.profiler",
        "polykey_tpu_torch.gateway.security", "polykey_tpu_torch.gateway.reflection",
        "polykey_tpu_torch.proto.reflection_v1_pb2",
        "polykey_tpu_torch.proto.reflection_v1alpha_pb2"} <= set(names)
import chip_smoke
assert callable(chip_smoke.phase_shell)
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
