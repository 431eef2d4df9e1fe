"""The port's autopilot (polykey_tpu_torch/engine/autopilot.py) against the
JAX package's (polykey_tpu/engine/autopilot.py), on the CPU.

- The pure core: every `decide_*` and `evaluate`, over the canned
  scenarios of tests/test_autopilot.py (hysteresis bands, cooldowns,
  bounds, no-flap, `None` holds, the min-evidence gate), decide the same
  in both packages.
- `apply_engine_knobs` on a tiny port engine and a tiny JAX engine of the
  same config applies the same clamped values; `knob_setpoints` agree.
- The controller thread: it refuses to start with the signal plane off,
  builds the JAX controller's state over the same engine config, and on a
  supervised restart of a pool replica re-applies its setpoints to the
  fresh engine before it re-arms.
"""

import dataclasses
import time

import jax
import pytest
import torch

from polykey_tpu.engine import autopilot as jap
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch import faults
from polykey_tpu_torch.engine import autopilot as ap
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.engine.replica_pool import SERVING, ReplicaPool
from polykey_tpu_torch.models.interop import params_from_numpy

torch.set_num_threads(2)

FIELDS = dict(model="tiny-llama", tokenizer="byte", dtype="float32",
              max_decode_slots=4, page_size=8, num_pages=64, max_seq_len=64,
              prefill_buckets=(16,), max_new_tokens_cap=32,
              default_max_new_tokens=8, decode_block_steps=4,
              signals_interval_s=0.05)


def _cfg(module):
    return module.AutopilotConfig(
        interval_s=0.05, cooldown_s=10.0, target_busy=0.75, lookahead_max=6,
        tier_min=1, tier_max=3, queue_high_s=0.3, queue_low_s=0.03,
        min_evidence_s=10.0)


def _state(module, **over):
    """tests/test_autopilot.py's make_state, with overrides:
    setpoints / baselines / bounds / last_fired entries by action name."""
    state = module.ControllerState()
    state.setpoints = {module.LOOKAHEAD: 2, module.PREFILL_BUDGET: 32,
                       module.RESTORE_SLOTS: 2, module.RESIDENT_FLOOR: 8,
                       module.ROUTE_DELAY_WEIGHT: 1.0}
    state.baselines = dict(state.setpoints)
    state.bounds = {module.LOOKAHEAD: (2, 6), module.PREFILL_BUDGET: (16, 64),
                    module.RESTORE_SLOTS: (2, 4), module.RESIDENT_FLOOR: (8, 32),
                    module.ROUTE_DELAY_WEIGHT: (1.0, 8.0)}
    state.steps = {module.PREFILL_BUDGET: 16, module.RESIDENT_FLOOR: 4}
    for field, entries in over.items():
        for action, value in entries.items():
            if value is None:
                getattr(state, field).pop(action, None)
            else:
                getattr(state, field)[action] = value
    return state


def _sum(**kw):
    return {"covered_s": 60.0, **kw}


def _replicas(*p95s):
    return {i: {"windows": {"1m": {"covered_s": 60.0, "ttft_ms_p95": v}}}
            for i, v in enumerate(p95s)}


def _tiers(delay, serving=1, total=None):
    return {"decode": {"queue_delay_s": delay, "serving": serving,
                       "total": serving if total is None else total}}


SPEC = dict(setpoints={"spec_gamma": 4}, baselines={"spec_gamma": 4},
            bounds={"spec_gamma": (2, 4)})
SPEC_LOW = dict(setpoints={"spec_gamma": 2}, baselines={"spec_gamma": 4},
                bounds={"spec_gamma": (2, 4)})

# name: (function, positional args before (state, cfg, now), state
# overrides, now).
DECIDE = {
    "lookahead-up": ("decide_lookahead", (_sum(host_stall_ms_p95=5.0,
                                               device_busy_fraction=0.4),), {}, 100.0),
    "lookahead-busy-holds": ("decide_lookahead", (_sum(host_stall_ms_p95=5.0,
                                                       device_busy_fraction=0.9),), {}, 100.0),
    "lookahead-relaxes": ("decide_lookahead", (_sum(host_stall_ms_p95=0.0,
                                                    device_busy_fraction=0.9),),
                          {"setpoints": {"lookahead": 4}}, 100.0),
    "lookahead-at-baseline": ("decide_lookahead", (_sum(host_stall_ms_p95=0.0,
                                                        device_busy_fraction=0.9),), {},
                              100.0),
    "lookahead-bounded": ("decide_lookahead", (_sum(host_stall_ms_p95=5.0,
                                                    device_busy_fraction=0.4),),
                          {"setpoints": {"lookahead": 6}}, 100.0),
    "lookahead-null": ("decide_lookahead", (_sum(host_stall_ms_p95=None,
                                                 device_busy_fraction=None),), {}, 100.0),
    "lookahead-band": ("decide_lookahead", (_sum(host_stall_ms_p95=0.5,
                                                 device_busy_fraction=0.5),), {}, 100.0),
    "lookahead-cooldown": ("decide_lookahead", (_sum(host_stall_ms_p95=5.0,
                                                     device_busy_fraction=0.4),),
                           {"last_fired": {"lookahead": 95.0}}, 100.0),
    "lookahead-no-summary": ("decide_lookahead", (None,), {}, 100.0),
    "budget-narrows": ("decide_prefill_budget", (_sum(arrival_rate_per_s=2.0), None),
                       {}, 100.0),
    "budget-widens": ("decide_prefill_budget", (_sum(arrival_rate_per_s=0.0), None),
                      {}, 100.0),
    "budget-floor": ("decide_prefill_budget", (_sum(arrival_rate_per_s=2.0), None),
                     {"setpoints": {"prefill_budget": 16}}, 100.0),
    "budget-null": ("decide_prefill_budget", (_sum(arrival_rate_per_s=None), None), {},
                    100.0),
    "budget-band": ("decide_prefill_budget", (_sum(arrival_rate_per_s=0.2), None), {},
                    100.0),
    "budget-pool-rate": ("decide_prefill_budget",
                         (None, {"1m": {"covered_s": 60.0,
                                        "handoffs": {"ok": 120, "failed": 0}}}), {}, 100.0),
    "restore-up": ("decide_restore_slots", (_sum(kv_fault_rate_per_min=90.0,
                                                 kv_restore_ms_p50=2.0,
                                                 kv_restore_ms_p95=9.0),), {}, 100.0),
    "restore-decays": ("decide_restore_slots", (_sum(kv_fault_rate_per_min=0.0),),
                       {"setpoints": {"restore_slots": 4}}, 100.0),
    "restore-no-tier": ("decide_restore_slots", (_sum(kv_fault_rate_per_min=90.0),),
                        {"setpoints": {"restore_slots": None}}, 100.0),
    "floor-up": ("decide_resident_floor", (_sum(kv_fault_rate_per_min=90.0),), {},
                 100.0),
    "floor-decays": ("decide_resident_floor", (_sum(kv_fault_rate_per_min=0.0),),
                     {"setpoints": {"resident_floor": 20}}, 100.0),
    "floor-bounded": ("decide_resident_floor", (_sum(kv_fault_rate_per_min=90.0),),
                      {"setpoints": {"resident_floor": 32}}, 100.0),
    "gamma-collapse": ("decide_gamma", (_sum(spec_accept_rate=0.12),), SPEC, 100.0),
    "gamma-recovers": ("decide_gamma", (_sum(spec_accept_rate=0.8),), SPEC_LOW, 100.0),
    "gamma-band-up": ("decide_gamma", (_sum(spec_accept_rate=0.45),), SPEC, 100.0),
    "gamma-band-low": ("decide_gamma", (_sum(spec_accept_rate=0.45),), SPEC_LOW, 100.0),
    "gamma-at-low": ("decide_gamma", (_sum(spec_accept_rate=0.12),), SPEC_LOW, 100.0),
    "gamma-at-cap": ("decide_gamma", (_sum(spec_accept_rate=0.9),), SPEC, 100.0),
    "gamma-null": ("decide_gamma", (_sum(spec_accept_rate=None),), SPEC, 100.0),
    "gamma-spec-off": ("decide_gamma", (_sum(spec_accept_rate=0.12),), {}, 100.0),
    "gamma-cooldown": ("decide_gamma", (_sum(spec_accept_rate=0.12),),
                       {**SPEC, "last_fired": {"spec_gamma": 95.0}}, 100.0),
    "route-skew": ("decide_route_weights", (_replicas(50.0, 900.0),), {}, 100.0),
    "route-healed": ("decide_route_weights", (_replicas(50.0, 60.0),),
                     {"setpoints": {"route_delay_weight": 4.0}}, 100.0),
    "route-single": ("decide_route_weights", (_replicas(900.0),), {}, 100.0),
    "route-bounded": ("decide_route_weights", (_replicas(50.0, 900.0),),
                      {"setpoints": {"route_delay_weight": 8.0}}, 100.0),
    "scale-up": ("decide_scale", ("decode", _tiers(1.0)), {}, 100.0),
    "scale-at-max": ("decide_scale", ("decode", _tiers(1.0, serving=2, total=3)), {},
                     100.0),
    "scale-boot-in-flight": ("decide_scale", ("decode", _tiers(5.0, serving=1, total=2)),
                             {}, 100.0),
    "scale-down": ("decide_scale", ("decode", _tiers(0.0, serving=2)), {}, 100.0),
    "scale-at-min": ("decide_scale", ("decode", _tiers(0.0, serving=1)), {}, 100.0),
    "scale-null": ("decide_scale", ("decode", _tiers(None, serving=2)), {}, 100.0),
    "scale-no-tiers": ("decide_scale", ("prefill", None), {}, 100.0),
}


def _decide(module, name):
    fn, args, over, now = DECIDE[name]
    decision = getattr(module, fn)(*args, _state(module, **over), _cfg(module), now)
    return None if decision is None else decision.as_dict()


@pytest.mark.parametrize("name", sorted(DECIDE))
def test_each_decision_matches_the_jax_controller(name):
    assert _decide(ap, name) == _decide(jap, name)


def _snap(**agg):
    return {"aggregate": {"1m": _sum(**agg)}}


# name: a list of (snapshot, now, state overrides applied before it), run
# through `evaluate` with one state per package, `_apply`'s bookkeeping
# simulated after each decision.
EVALUATE = {
    "cooldown": [(_snap(host_stall_ms_p95=5.0, device_busy_fraction=0.4), t)
                 for t in (100.0, 105.0, 111.0)],
    "min-evidence": [({"aggregate": {"1m": {"covered_s": 1.0, "host_stall_ms_p95": 5.0,
                                            "device_busy_fraction": 0.4}}}, 100.0)],
    "no-flap": [(_snap(host_stall_ms_p95=0.8 if i % 2 else 0.1, device_busy_fraction=0.5,
                       arrival_rate_per_s=0.2, kv_fault_rate_per_min=10.0), 100.0 + i)
                for i in range(50)],
    "empty": [({}, 100.0)],
    "everything": [({"aggregate": {"5m": _sum(host_stall_ms_p95=3.0),
                                   "1m": _sum(host_stall_ms_p95=5.0,
                                              device_busy_fraction=0.4,
                                              arrival_rate_per_s=2.0,
                                              kv_fault_rate_per_min=90.0)},
                     "replicas": _replicas(10.0, 2000.0),
                     "tiers": {**_tiers(1.0), "prefill": {"queue_delay_s": 0.0,
                                                          "serving": 2, "total": 2}}},
                    t) for t in (100.0, 120.0, 140.0)],
}


def _evaluate(module, name):
    state, cfg, out = _state(module), _cfg(module), []
    for snapshot, now in EVALUATE[name]:
        decisions = module.evaluate(snapshot, state, cfg, now)
        for d in decisions:
            state.last_fired[d.action] = now
            if d.action not in (module.SCALE_PREFILL, module.SCALE_DECODE):
                state.setpoints[d.action] = d.new
        out.append([d.as_dict() for d in decisions])
    return out


@pytest.mark.parametrize("name", sorted(EVALUATE))
def test_evaluate_matches_the_jax_controller(name):
    got = _evaluate(ap, name)
    assert got == _evaluate(jap, name)
    if name == "no-flap":
        assert not any(got)


# -- on engines --------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port engine of one config with the host-KV tier (so the
    restore and floor knobs exist), on one params tree."""
    fields = dict(FIELDS, prefix_cache=True, host_kv_bytes=1 << 20)
    jparams = jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                             jax.numpy.float32)
    jeng = JInferenceEngine(JEngineConfig(**fields), params=jparams)
    teng = InferenceEngine(EngineConfig(**fields), device="cpu",
                           params=params_from_numpy(jax.device_get(jparams)))
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


KNOBS = [
    {"lookahead": 100}, {"lookahead": 0}, {"lookahead": 3},
    {"prefill_budget": 1}, {"prefill_budget": 40},
    {"restore_slots": 99}, {"restore_slots": 0}, {"restore_slots": 3},
    {"resident_floor": 10_000}, {"resident_floor": -5}, {"resident_floor": 12},
    {"spec_gamma": 2}, {"nonsense": 3}, {"lookahead": "x"},
    {"lookahead": 2, "prefill_budget": 16, "restore_slots": 2, "resident_floor": 8},
]


@pytest.mark.parametrize("knobs", KNOBS, ids=[str(k) for k in KNOBS])
def test_apply_engine_knobs_clamps_as_the_jax_engine(engines, knobs):
    jeng, teng = engines
    assert ap.apply_engine_knobs(teng, knobs) == jap.apply_engine_knobs(jeng, knobs)
    assert teng.knob_setpoints() == jeng.knob_setpoints()


def test_the_controller_state_matches_the_jax_controllers(engines):
    jeng, teng = engines
    for name, value in {"lookahead": 2, "prefill_budget": 32, "restore_slots": 2,
                        "resident_floor": 8}.items():
        ap.apply_engine_knobs(teng, {name: value})
        jap.apply_engine_knobs(jeng, {name: value})
    ours = ap.Autopilot(teng, config=_cfg(ap))._build_state()
    theirs = jap.Autopilot(jeng, config=_cfg(jap))._build_state()
    assert vars(ours) == vars(theirs)


def test_refuses_to_start_without_the_signal_plane():
    engine = InferenceEngine(EngineConfig(**{**FIELDS, "signals_interval_s": 0.0}),
                             device="cpu")
    try:
        with pytest.raises(ap.AutopilotUnavailableError, match="signal plane"):
            ap.Autopilot(engine, config=_cfg(ap)).start()
        assert getattr(engine, "autopilot", None) is None
    finally:
        engine.shutdown()


def test_maybe_start_is_off_by_default(monkeypatch):
    monkeypatch.delenv("POLYKEY_AUTOPILOT", raising=False)
    assert ap.maybe_start(object()) is None
    monkeypatch.setenv("POLYKEY_AUTOPILOT_INTERVAL", "0.01")
    monkeypatch.setenv("POLYKEY_AUTOPILOT_TARGET_BUSY", "2")
    assert vars(ap.AutopilotConfig.from_env()) == vars(jap.AutopilotConfig.from_env())


def test_a_restarted_replica_gets_the_setpoints_back():
    """The autopilot over a pool: a watchdog trip pauses it; the supervisor
    restarts the replica, whose fresh engine boots with the config's knobs;
    the restart listener re-applies the current setpoints, then re-arms.
    A tick moves setpoints through the pool to every replica."""
    faults.clear()
    config = EngineConfig(**{**FIELDS, "decode_block_steps": 1, "adaptive_block": False,
                             "lookahead_blocks": 1}, watchdog_timeout_s=0.3,
                          replicas=2)
    pool = ReplicaPool.create(config, device="cpu", watchdog_interval_s=0.05,
                              supervisor_interval_s=0.05)
    pilot = None
    try:
        pool.apply_engine_knobs({"lookahead": 3, "prefill_budget": 48})
        pilot = ap.Autopilot(pool, config=dataclasses.replace(_cfg(ap), interval_s=60.0))
        pilot.start()
        assert pool.autopilot is pilot
        assert pilot.state.setpoints["lookahead"] == 3
        # A decision, applied by a tick on a canned snapshot.
        pilot.state.setpoints["lookahead"] = 3
        decision = ap.Decision(ap.LOOKAHEAD, ap.UP, "test", 5.0, 3, 4)
        pilot._apply(decision, time.monotonic())
        assert [r.engine.knob_setpoints()["lookahead"] for r in pool.replicas] == [4, 4]
        pool.replicas[0].engine._faults = faults.install(
            "slow-step=0.05:replica=0,step-stall=1.0@1:replica=0")
        victim = GenRequest(prompt="pause me", max_new_tokens=8)
        pool.submit(victim)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not (
                pool.replicas[0].supervisor.restarts == 1
                and pool.replicas[0].state == SERVING and not pilot.paused):
            time.sleep(0.02)
        fresh = pool.replicas[0].engine
        assert pool.replicas[0].supervisor.restarts == 1 and not pilot.paused
        assert fresh.knob_setpoints()["lookahead"] == 4
        assert fresh.knob_setpoints()["prefill_budget"] == 48
        kinds = [e.get("note_kind") for e in pool.replicas[0].engine.timeline.events()]
        assert "engine_restart" in kinds
        snap = pilot.snapshot()
        assert snap["decisions_total"] == {"lookahead:up": 1}
        assert snap["setpoints"]["lookahead"] == 4
    finally:
        faults.clear()
        if pilot is not None:
            pilot.stop()
        pool.shutdown()
