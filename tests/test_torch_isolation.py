"""The port stands alone: every module of polykey_tpu_torch (the prefix
cache, the KV wire format, quantized weights, the MoE layer, the
checkpoint loader, the speculative round, offline generation and the
serving shell — faults, the watchdog, the supervisor, obs/*, the secret
store, reflection and its protos —, the replica tier — the signal
plane, the replica pool, the autopilot and the dev client — and the
disaggregated tiers — the worker, the pool, clock sync and the black
boxes — and graphlint's tier with the host-sync guard among them), and
chip_smoke.py with its shell, replicas, disagg and graphlint phases,
imports with
JAX, Flax, ml_dtypes, the JAX package, safetensors, orbax, tensorstore
and zstandard made unimportable (in a fresh interpreter, so this test
process's own JAX imports cannot mask a leak); and the orbax format is
written and read back there, through the port's own codec."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys

sys.modules["jax"] = None
BLOCKED = ("jax", "flax", "ml_dtypes", "polykey_tpu", "safetensors", "orbax",
           "cryptography", "tensorstore", "zstandard")

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
        "polykey_tpu_torch.proto.reflection_v1alpha_pb2",
        "polykey_tpu_torch.obs.signals", "polykey_tpu_torch.engine.replica_pool",
        "polykey_tpu_torch.engine.autopilot", "polykey_tpu_torch.gateway.client",
        "polykey_tpu_torch.gateway.config", "polykey_tpu_torch.gateway.beautify",
        "polykey_tpu_torch.gateway.log_beautifier",
        "polykey_tpu_torch.engine.worker", "polykey_tpu_torch.engine.disagg_pool",
        "polykey_tpu_torch.obs.clocks", "polykey_tpu_torch.obs.postmortem",
        "polykey_tpu_torch.analysis.graph", "polykey_tpu_torch.analysis.core",
        "polykey_tpu_torch.analysis.__main__", "polykey_tpu_torch.engine.host_guard",
        "polykey_tpu_torch.tools.crossing_cost"} <= set(names)
import chip_smoke
assert callable(chip_smoke.phase_shell) and callable(chip_smoke.phase_replicas)
assert callable(chip_smoke.phase_disagg) and callable(chip_smoke.phase_graphlint)
# graphlint's abstract contracts and gates run with every blocker in place.
from polykey_tpu_torch.analysis import graph
from polykey_tpu_torch.models.config import get_config
assert graph._GRAPH_REGISTRY["GL005"]._kernel_contracts() == []
assert graph.gate_consistency_findings(
    [get_config(m) for m in graph.ShapeLayoutContracts.MODELS]) == []
# The reference's orbax layout, written and read with every blocker in place.
import tempfile, torch
from polykey_tpu_torch.models import loader
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.transformer import init_params
cfg = get_config("tiny-llama")
params = init_params(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
with tempfile.TemporaryDirectory() as tmp:
    loader.save_checkpoint(tmp + "/ckpt", params)
    back = loader.load_checkpoint(tmp + "/ckpt", cfg, torch.float32)
assert torch.equal(back["layers"][1]["mlp"]["down"], params["layers"][1]["mlp"]["down"])
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
