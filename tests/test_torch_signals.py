"""The port's SLO signal plane (polykey_tpu_torch/obs/signals.py) against
the JAX package's (polykey_tpu/obs/signals.py), on the CPU.

- The same scripted metrics (counter moves and histogram observations at
  synthetic times) through both packages' `EngineMetrics` and
  `SignalPlane`: equal windowed summaries (rates, delta-quantiles), equal
  SLO state (burn rates, budget, breaches) and the same breach and
  recovery events on the timeline and in the flight recorder.
- The same POLYKEY_SLO and window specs parse to the same objectives, or
  raise the same error; `merge_deltas`, `summarize_deltas` and the alert
  rules agree.
- A tiny engine of each package after the same greedy requests: the
  port's `signals_snapshot` has the JAX key set, its `stats()` the JAX
  windowed keys, and sampling never reads the device.
"""

import json
import queue
import time

import jax
import pytest
import torch

from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.engine.metrics import EngineMetrics as JEngineMetrics
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu.obs import signals as jsignals
from polykey_tpu.obs.timeline import TimelineRecorder as JTimelineRecorder
from polykey_tpu.obs.trace import FlightRecorder as JFlightRecorder
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.engine.metrics import EngineMetrics
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.obs import signals
from polykey_tpu_torch.obs.timeline import TimelineRecorder
from polykey_tpu_torch.obs.trace import FlightRecorder

torch.set_num_threads(2)

POLICY = [
    {"name": "ttft", "kind": "latency", "signal": "ttft_ms", "threshold_ms": 100.0,
     "target": 0.9},
    {"name": "itl", "kind": "latency", "signal": "itl_ms", "threshold_ms": 50.0,
     "target": 0.95, "burn_threshold": 2.0},
    {"name": "avail", "kind": "availability", "target": 0.9},
    {"name": "busy", "kind": "floor", "signal": "device_busy_fraction", "target": 0.9,
     "time_budget": 0.25},
    {"name": "rate", "kind": "ceiling", "signal": "tokens_per_sec", "target": 50.0},
]


def _bump(metrics, **moves):
    for name, by in moves.items():
        if name in ("queued", "prefill", "decode"):
            metrics.deadline_expired[name] += by
        else:
            setattr(metrics, name, getattr(metrics, name) + by)


# Scripts: (seconds after t0, [(action, args)]) with a sample after each.
SCRIPTS = {
    "rates": [
        (0.0, []),
        (0.1, []),                                  # inside the interval gate
        (10.0, [("on_step", (100,)), ("on_admit", ()), ("on_admit", ())]),
        (20.0, [("on_step", (40,)), ("bump", {"lane_steps": 30, "steps_dispatched": 10,
                                              "blocks_processed": 4, "lookahead_sum": 6,
                                              "blocks_synced": 4,
                                              "host_stall_ms_total": 2.5})]),
    ],
    "stale-quantiles": [
        (0.0, [("ttft", 5000.0, 100), ("itl", 300.0, 50)]),
        (4.0, [("ttft", 10.0, 100), ("itl", 3.0, 200)]),
        (8.0, [("ttft", 40.0, 7), ("stall", 0.2, 9), ("device_ms", 12.0, 3),
               ("restore", 1.5, 4)]),
    ],
    "latency-breach-recover": [
        (0.0, []),
        (10.0, [("ttft", 10.0, 8), ("ttft", 5000.0, 2), ("itl", 100.0, 30),
                ("itl", 1.0, 70)]),
        (20.0, [("ttft", 10.0, 100), ("itl", 1.0, 100)]),
        (30.0, [("ttft", 500.0, 50)]),
    ],
    "availability": [
        (0.0, []),
        (10.0, [("bump", {"requests_completed": 6, "requests_shed": 1,
                          "requests_failed": 3, "queued": 1})]),
        (20.0, [("bump", {"requests_completed": 40})]),
    ],
    "floor-time-budget": [
        (0.0, []),
        (2.0, [("bump", {"dispatch_gap_ms_total": 1000.0, "device_busy_ms_total": 500.0})]),
        *[(2.0 + 2.0 * i, [("bump", {"dispatch_gap_ms_total": 1000.0,
                                     "device_busy_ms_total": 990.0})]) for i in range(1, 6)],
        (14.0, [("on_step", (2000,))]),
    ],
    "kv-and-spec": [
        (0.0, []),
        (6.0, [("bump", {"drafts_accepted": 30, "drafts_proposed": 80,
                         "kv_pages_restored": 12, "kv_pages_evicted": 3}),
               ("fault", ("prefix", 5)), ("fault", ("ctx", 2))]),
    ],
    "no-evidence": [(0.0, []), (10.0, [])],
}


def _drive(metrics_cls, module, timeline_cls, recorder_cls, script):
    metrics = metrics_cls()
    timeline, recorder = timeline_cls(64), recorder_cls(capacity=16)
    plane = module.SignalPlane(metrics, windows=(1.0, 10.0), interval_s=0.5,
                               policy=module.SloPolicy.from_json(POLICY),
                               timeline=timeline, recorder=recorder)
    hists = {"ttft": metrics.ttft_hist, "itl": metrics.itl_hist,
             "stall": metrics.host_stall_hist, "device_ms": metrics.device_ms_hist,
             "restore": metrics.kv_restore_hist}
    t0, trace = 1000.0, []
    for dt, actions in script:
        for action, *args in actions:
            if action == "bump":
                _bump(metrics, **args[0])
            elif action == "fault":
                metrics.on_kv_fault(*args[0])
            elif action in hists:
                value, n = args
                for _ in range(n):
                    hists[action].observe(value)
            else:
                getattr(metrics, action)(*args[0])
        sampled = plane.maybe_sample(now=t0 + dt)
        trace.append((sampled, plane.samples(),
                      {w: plane.window_summary(w) for w in plane.windows},
                      plane.slo_state()))
    notes = [(e["note_kind"], e["attrs"]) for e in timeline.events()
             if e["kind"] == "note"]
    events = [{k: v for k, v in e.items() if k not in ("monotonic", "time")}
              for e in recorder.events()]
    return trace, notes, events


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_the_same_script_gives_the_same_windows_and_slo_state(name):
    want = _drive(JEngineMetrics, jsignals, JTimelineRecorder, JFlightRecorder,
                  SCRIPTS[name])
    got = _drive(EngineMetrics, signals, TimelineRecorder, FlightRecorder,
                 SCRIPTS[name])
    assert got == want
    if name == "latency-breach-recover":
        kinds = [kind for kind, _ in got[1]]
        assert "slo_breach" in kinds and "slo_recovered" in kinds


SPECS = [
    "", "default", json.dumps(POLICY), json.dumps({"objectives": POLICY[:2]}),
    json.dumps([{"name": "x", "kind": "weird"}]),
    json.dumps([{"name": "x,y", "kind": "availability"}]),
    json.dumps([{"name": "x", "kind": "availability"}] * 2),
    json.dumps([{"name": "x", "kind": "availability", "bogus": 1}]),
    json.dumps([{"name": "x", "kind": "latency", "signal": "ttft_ms"}]),
    json.dumps([{"name": "x", "kind": "latency", "signal": "nope", "threshold_ms": 1}]),
    json.dumps([{"name": "x", "kind": "availability", "target": 1.0}]),
    json.dumps([{"name": "x", "kind": "floor", "signal": "avg_lanes", "target": 2,
                 "time_budget": 0}]),
    json.dumps([{"name": "x", "kind": "ceiling", "signal": "ttft_ms"}]),
    json.dumps([{"name": "x", "kind": "availability", "burn_threshold": 0}]),
    json.dumps("not a list"),
]


def _parse(module, spec):
    try:
        policy = module.SloPolicy.from_spec(spec)
    except ValueError as e:
        return ("error", str(e))
    if policy is None:
        return None
    return [vars(o) for o in policy.objectives]


@pytest.mark.parametrize("spec", SPECS)
def test_slo_specs_parse_alike(spec):
    assert _parse(signals, spec) == _parse(jsignals, spec)


def test_policy_from_a_file_and_the_env(tmp_path, monkeypatch):
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(POLICY))
    assert _parse(signals, f"@{path}") == _parse(jsignals, f"@{path}")
    monkeypatch.setenv("POLYKEY_SLO", "default")
    assert [vars(o) for o in signals.SloPolicy.from_env().objectives] == [
        vars(o) for o in jsignals.SloPolicy.from_env().objectives]


@pytest.mark.parametrize("spec", ["", "60,300", "5, 1", "1,x", "0,10", ",", "-1"])
def test_window_specs_parse_alike(spec):
    def parse(module):
        try:
            return module.windows_from_spec(spec)
        except ValueError as e:
            return str(e)

    assert parse(signals) == parse(jsignals)
    assert [signals.window_label(w) for w in (1, 60, 90, 300, 3600, 7200, 2.5)] == [
        jsignals.window_label(w) for w in (1, 60, 90, 300, 3600, 7200, 2.5)]


def test_merge_summarize_and_alert_rules_agree():
    bounds = {name: list(range(1, 20)) for name in jsignals.HIST_SIGNALS}
    parts = [
        {"covered_s": 5.0, "counters": {"requests_completed": 3, "tokens_generated": 90,
                                        "requests_admitted": 4},
         "hists": {"ttft_ms": ((1, 2, 3) + (0,) * 17, 30.0)}},
        None,
        {"covered_s": 7.0, "counters": {"requests_completed": 1, "requests_failed": 1},
         "hists": {"ttft_ms": ((0, 0, 5) + (0,) * 17, 20.0),
                   "itl_ms": ((4,) + (0,) * 19, 4.0)}},
    ]
    merged = signals.merge_deltas(parts)
    assert merged == jsignals.merge_deltas(parts)
    assert signals.merge_deltas([None]) is None
    assert signals.summarize_deltas(merged, bounds) == jsignals.summarize_deltas(
        merged, bounds)
    policy = signals.SloPolicy.from_json(POLICY)
    jpolicy = jsignals.SloPolicy.from_json(POLICY)
    ours = signals.alert_rules_yaml(policy, (60.0, 300.0, 3600.0)).splitlines()
    theirs = jsignals.alert_rules_yaml(jpolicy, (60.0, 300.0, 3600.0)).splitlines()
    assert ours[0].endswith("polykey_tpu_torch.obs.signals --emit-alert-rules")
    assert ours[1:] == theirs[1:]


def test_alert_rules_cli(capsys):
    assert signals.main(["--emit-alert-rules", "--policy", "default",
                         "--windows", "60,300"]) == 0
    out = capsys.readouterr().out
    assert "PolykeySloFastBurnInteractiveTtft" in out and out.startswith("# Generated")


# -- on engines --------------------------------------------------------------

FIELDS = dict(model="tiny-llama", tokenizer="byte", dtype="float32",
              max_decode_slots=4, page_size=8, num_pages=64, max_seq_len=64,
              prefill_buckets=(16, 32), max_new_tokens_cap=32,
              default_max_new_tokens=8, signals_interval_s=0.05,
              signals_windows="1,60", slo_policy="default")


def _drain(request, timeout=60.0):
    tokens = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            kind, value = request.out.get(timeout=deadline - time.monotonic())
        except queue.Empty:
            break
        if kind == "token":
            tokens.append(value)
        else:
            assert kind == "done", value
            return tokens
    raise AssertionError("no done event")


def _keys(tree):
    """The key structure; a window's quantile keys are left out, since
    they appear only when the window holds an observation, which depends
    on when each engine's requests ran."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()
                if not k.endswith(("_p50", "_p95", "_p99"))}
    return None


@pytest.fixture(scope="module")
def engines():
    jparams = jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                             jax.numpy.float32)
    jeng = JInferenceEngine(JEngineConfig(**FIELDS), params=jparams)
    teng = InferenceEngine(EngineConfig(**FIELDS), device="cpu",
                           params=params_from_numpy(jax.device_get(jparams)))
    for prompt in ("hello", "a prompt for the 32 bucket", "third"):
        want = _drain_submit(jeng, JGenRequest, prompt)
        assert _drain_submit(teng, GenRequest, prompt) == want
    time.sleep(0.3)                       # a few idle-tick samples
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _drain_submit(engine, make, prompt):
    request = make(prompt=prompt, max_new_tokens=8)
    engine.submit(request)
    return _drain(request)


def test_signals_snapshot_has_the_jax_key_set(engines):
    jeng, teng = engines
    want = jsignals.signals_snapshot(jeng)
    got = signals.signals_snapshot(teng)
    assert _keys(got) == _keys(want)
    assert got["replicas"]["0"]["samples"] >= 2
    assert signals.signals_available(teng) and jsignals.signals_available(jeng)
    assert got["aggregate"]["1s"] is None or "tokens_per_sec" in got["aggregate"]["1s"]


def test_engine_stats_carry_the_windowed_keys(engines):
    jeng, teng = engines
    windowed = {k for k in jeng.stats() if k.endswith("_1m")}
    assert windowed and windowed <= set(teng.stats())
    assert teng.metrics.signals.timeline is teng.timeline


def test_sampling_reads_no_device(engines, monkeypatch):
    """A sample reads host counters only: no synchronize, no .item()."""
    _, teng = engines

    def refuse(*args, **kwargs):
        raise AssertionError("the signal plane touched the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    teng.metrics.signals.sample_now()
    signals.signals_snapshot(teng)


def test_disabled_plane_allocates_nothing():
    engine = InferenceEngine(EngineConfig(**{**FIELDS, "signals_interval_s": 0.0}),
                             device="cpu")
    try:
        assert engine.metrics.signals is None
        assert not signals.signals_available(engine)
        assert not any(k.endswith("_1m") for k in engine.stats())
    finally:
        engine.shutdown()


def test_a_disaggregated_target_is_refused_by_name():
    """The disaggregated pool is served now: a target with `workers` is no
    longer refused. Its engines live in other processes, so the snapshot
    holds no replica plane but the pool's own windows, tiers, handoff
    signals and clock offsets, as the reference's does for the same target
    (tests/test_torch_disagg.py drives a live pool)."""
    import types

    class Disagg:
        workers = ()
        config = types.SimpleNamespace(signals_interval_s=0.0)

        def signal_windows(self):
            return {"1m": {"covered_s": 1.0}}

        def handoff_now(self):
            return {"wire_bw_ewma_bytes_per_s": {"decode-0": 1e9}}

        def clock_offsets(self):
            return {"decode-0": {"offset_s": 0.5}}

        def tier_now(self):
            return {"prefill": {"serving": 1}, "decode": {"serving": 0}}

    snap = signals.signals_snapshot(Disagg())
    assert snap == jsignals.signals_snapshot(Disagg())
    assert snap["replicas"] == {} and "aggregate" not in snap
    assert snap["pool"] == {"1m": {"covered_s": 1.0}}
    assert snap["tiers"]["decode"]["serving"] == 0
    signals.bind_recorder(Disagg(), FlightRecorder())   # nothing in process to bind
    assert not signals.signals_available(Disagg())      # the config's interval is 0
