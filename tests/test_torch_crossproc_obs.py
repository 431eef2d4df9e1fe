"""The port's cross-process flight deck against the JAX package's (the
counterparts of tests/test_crossproc_obs.py): clock alignment, merged
timelines with handoff arcs, crash-durable black boxes, the postmortem,
and a live pool of in-thread workers over localhost on tiny-llama (fp32,
CPU).

- `ClockSync`, `merge_timelines` / `to_perfetto`, `BlackBox` and the
  postmortem are pure Python: every scenario runs through both packages'
  copies and the outputs must be equal (pids, paths and wall-clock stamps
  aside), beside the reference test's own assertions.
- Live pool: trace ids thread end to end across a re-route, the merged
  Perfetto export has the coordinator's and both workers' process rows and
  a handoff arc (held to that structure; the reference's own live-merge
  test is red in its run), the pool's signal windows feed
  `signals_snapshot`, black boxes on or off change nothing about the
  streams, and a killed decode worker's last ring is reconstructed from
  its black box alone.
"""

import json
import os
import re
import time

import jax
import pytest
import torch

from polykey_tpu import faults as jfaults
from polykey_tpu.obs import clocks as jclocks
from polykey_tpu.obs import postmortem as jpostmortem
from polykey_tpu.obs import timeline as jtimeline
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch import faults
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.disagg_pool import DECODE, PREFILL, DisaggPool
from polykey_tpu_torch.engine.engine import GenRequest
from polykey_tpu_torch.engine.worker import WorkerServer
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.obs import Span
from polykey_tpu_torch.obs.signals import signals_snapshot
from polykey_tpu_torch.obs import clocks as tclocks
from polykey_tpu_torch.obs import postmortem as tpostmortem
from polykey_tpu_torch.obs import timeline as ttimeline

torch.set_num_threads(2)

# (ClockSync, TimelineRecorder, merge_timelines, to_perfetto, postmortem) of
# each package.
PACKAGES = {
    "torch": (tclocks.ClockSync, ttimeline.TimelineRecorder, ttimeline.merge_timelines,
              ttimeline.to_perfetto, tpostmortem),
    "jax": (jclocks.ClockSync, jtimeline.TimelineRecorder, jtimeline.merge_timelines,
            jtimeline.to_perfetto, jpostmortem),
}


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


# -- clock alignment ----------------------------------------------------------


def _exchange(sync, local_t: float, skew: float, rtt: float = 0.002) -> None:
    """One ideal ping at local time `local_t` against a remote whose clock
    reads local - skew; the reply is stamped at the midpoint."""
    t_send = local_t
    t_recv = local_t + rtt
    sync.update(t_send, t_recv, (t_send + t_recv) / 2.0 - skew)


def _both(scenario):
    """Run `scenario(ClockSync)` for both packages; their results must agree."""
    out = [scenario(PACKAGES[name][0]) for name in ("torch", "jax")]
    assert out[0] == out[1]
    return out[0]


def test_clock_recovers_known_skew_within_bound():
    skew = 123.456789

    def scenario(cls):
        sync = cls()
        for i in range(10):
            _exchange(sync, 100.0 + i, skew, rtt=0.004)
        bound = sync.uncertainty(now=110.0)
        assert bound <= 0.002 + 200e-6 * 10.0 + 1e-9
        assert abs(sync.offset - skew) <= bound
        assert sync.to_local(50.0 - skew) == pytest.approx(50.0, abs=bound)
        return sync.offset, bound, sync.snapshot()["samples"], sync.accepted

    _both(scenario)


def test_clock_recovers_offset_under_asymmetric_noise():
    skew = -7.25

    def scenario(cls):
        sync = cls()
        for i in range(20):
            t_send = 10.0 + i
            rtt = 0.001 + (i % 5) * 0.002
            sync.update(t_send, t_send + rtt, t_send + 0.8 * rtt - skew)
        bound = sync.uncertainty(now=30.0)
        assert abs(sync.offset - skew) <= bound
        return sync.offset, bound, sync.accepted

    _both(scenario)


def test_clock_drift_ages_stale_estimate():
    def scenario(cls):
        sync = cls(drift_ppm=200.0)
        _exchange(sync, 0.0, 5.0, rtt=0.0001)
        tight = sync.uncertainty(now=0.0001)
        aged = sync.uncertainty(now=10000.0)
        assert aged > 1.9 and aged > tight
        assert sync.update(10000.0, 10000.5, 10000.25 - 5.0) is True
        assert sync.uncertainty(now=10000.5) <= 0.25 + 1e-9
        return tight, aged, sync.offset

    _both(scenario)


def test_clock_rejects_worse_samples_and_resets():
    def scenario(cls):
        sync = cls()
        _exchange(sync, 0.0, 1.0, rtt=0.001)
        assert sync.update(0.1, 0.5, 0.3 - 1.0) is False
        assert sync.update(1.0, 0.9, 0.95) is False
        assert sync.accepted == 1 and sync.samples == 2
        sync.reset()
        assert sync.offset is None and sync.uncertainty() is None
        assert sync.to_local(42.0) == 42.0
        return sync.snapshot()

    _both(scenario)


# -- merged timeline + handoff arcs -------------------------------------------


def _note(t: float, kind: str, **attrs) -> dict:
    return {"kind": "note", "t": t, "note_kind": kind, "attrs": attrs}


def _synthetic_groups(handoff_id: str = "h1"):
    """Coordinator + prefill + decode rings for one handoff, each on its own
    clock: prefill runs 10 s behind the coordinator, decode 3 s ahead."""
    coord = [
        _note(100.00, "handoff_start", handoff_id=handoff_id, trace="t-1"),
        _note(100.20, "handoff_ack", handoff_id=handoff_id, trace="t-1"),
    ]
    prefill = [
        _note(90.05, "prefill_op", handoff_id=handoff_id, trace="t-1"),
        _note(90.10, "handoff_serialize", handoff_id=handoff_id, trace="t-1", bytes=4096),
    ]
    decode = [
        _note(103.12, "decode_op", handoff_id=handoff_id, trace="t-1"),
        _note(103.15, "handoff_scatter", handoff_id=handoff_id, trace="t-1"),
    ]
    return [(0, "coordinator", coord, 0.0), (1, "prefill-0", prefill, 10.0),
            (2, "decode-0", decode, -3.0)]


def _arc_pair(trace: dict):
    starts = [e for e in trace["traceEvents"] if e.get("ph") == "s"]
    ends = [e for e in trace["traceEvents"] if e.get("ph") == "f"]
    return starts, ends


def _rows(trace: dict) -> dict:
    return {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "process_name"}


@pytest.mark.parametrize("groups", ["all", "one-sided"])
def test_merged_timeline_golden(groups):
    """The merge and the export of the same rings: equal between the
    packages; three process rows and one arc causally ordered after
    alignment (50 ms of wire time), or no arc when the decode ring is gone
    (an abort mid-wire)."""
    traces = []
    for name in ("torch", "jax"):
        _, _, merge, to_perfetto, _ = PACKAGES[name]
        chosen = _synthetic_groups() if groups == "all" else _synthetic_groups()[:2]
        merged = merge(chosen)
        trace = to_perfetto(merged, meta={"clock_offsets": {"prefill-0": 10.0}})
        json.loads(json.dumps(trace))
        traces.append(trace)
    assert traces[0] == traces[1]
    trace = traces[0]
    starts, ends = _arc_pair(trace)
    if groups == "one-sided":
        assert starts == [] and ends == []
        return
    assert trace["otherData"]["clock_offsets"]["prefill-0"] == 10.0
    assert _rows(trace) == {0: "polykey coordinator", 1: "polykey prefill-0",
                            2: "polykey decode-0"}
    assert len(starts) == 1 and len(ends) == 1
    start, end = starts[0], ends[0]
    assert start["id"] == end["id"] == "h1" and end["bp"] == "e"
    assert start["pid"] == 1 and end["pid"] == 2
    assert start["ts"] <= end["ts"]
    assert end["ts"] - start["ts"] == pytest.approx(50e3, rel=0.01)


def test_merged_timeline_input_not_mutated():
    groups = _synthetic_groups()
    before = json.dumps(groups)
    merged = [PACKAGES[n][2](groups) for n in ("torch", "jax")]
    assert json.dumps(groups) == before
    assert merged[0] == merged[1]
    assert merged[0][1][2][1]["t"] == pytest.approx(100.10)


# -- black boxes --------------------------------------------------------------


def _normalized(box: dict) -> dict:
    """A box without what differs between two writers: its path, pid and
    the stamps of its write."""
    return {k: v for k, v in box.items()
            if k not in ("_path", "pid", "wrote_mono", "wrote_unix")}


def _box_scenario(name, state_dir):
    _, Recorder, _, _, pm = PACKAGES[name]
    ring = Recorder(capacity=64)
    box = pm.BlackBox(state_dir, "decode-0", timeline=ring, every=8, meta={"tier": "decode"})
    ticks = [box.tick()]
    for i in range(7):
        ring.note("warmup", i=i)
        ticks.append(box.tick())
    ring.note("edge", i=7)
    ticks.append(box.tick())
    ring.note("fatal", trace="t-dead")
    ticks.append(box.tick(force=True))
    assert not os.path.exists(box.path + ".tmp")
    return ticks, box.flushes, pm.load_blackboxes(state_dir)


def test_blackbox_roundtrip_and_amortization(tmp_path):
    out = {}
    for name in ("torch", "jax"):
        out[name] = _box_scenario(name, str(tmp_path / name))
    ticks, flushes, boxes = out["torch"]
    assert ticks == [True] + [False] * 7 + [True, True] and flushes == 3
    assert len(boxes) == 1
    loaded = boxes[0]
    assert loaded["role"] == "decode-0" and loaded["pid"] == os.getpid()
    assert loaded["meta"] == {"tier": "decode"}
    assert loaded["_path"] == tpostmortem.blackbox_path(str(tmp_path / "torch"),
                                                         "decode-0")
    traces = [e["attrs"].get("trace") for e in loaded["timeline"] if e["kind"] == "note"]
    assert "t-dead" in traces
    jticks, jflushes, jboxes = out["jax"]
    assert (ticks, flushes) == (jticks, jflushes)
    strip = [[{k: v for k, v in e.items() if k != "t"} for e in b["timeline"]] for b in
             (boxes[0], jboxes[0])]
    assert strip[0] == strip[1]
    assert _normalized({**boxes[0], "timeline": None}) == \
        _normalized({**jboxes[0], "timeline": None})


def test_blackbox_rebind_resets_mark(tmp_path):
    for name in ("torch", "jax"):
        _, Recorder, _, _, pm = PACKAGES[name]
        ring_a = Recorder(capacity=8)
        for _ in range(5):
            ring_a.note("old")
        assert ring_a.appended == 5
        box = pm.BlackBox(str(tmp_path / name), "prefill-0", timeline=ring_a, every=100)
        assert box.tick() is True
        assert box.tick() is False
        box.rebind(Recorder(capacity=8))
        assert box.tick() is True


def test_blackbox_rotation_preserves_dead_incarnation(tmp_path):
    roles = {}
    for name in ("torch", "jax"):
        _, Recorder, _, _, pm = PACKAGES[name]
        state_dir = str(tmp_path / name)
        dead_ring = Recorder(capacity=8)
        dead_ring.note("decode_op", trace="t-fatal")
        pm.BlackBox(state_dir, "decode-0", timeline=dead_ring).flush()
        pm.BlackBox(state_dir, "decode-0", timeline=Recorder(capacity=8)).flush()
        boxes = pm.load_blackboxes(state_dir)
        roles[name] = [b["role"] for b in boxes]
        traces = [e.get("attrs", {}).get("trace")
                  for b in boxes for e in b["timeline"] if e["kind"] == "note"]
        assert "t-fatal" in traces
    assert roles["torch"] == roles["jax"] == ["decode-0", "decode-0"]


def test_load_blackboxes_orders_and_skips_garbage(tmp_path):
    orders = {}
    for name in ("torch", "jax"):
        pm = PACKAGES[name][4]
        state_dir = str(tmp_path / name)
        for role in ("decode-0", "coordinator", "prefill-0"):
            pm.BlackBox(state_dir, role, timeline=None).flush()
        with open(os.path.join(state_dir, "blackbox-squatter.json"), "w") as f:
            f.write("{not json")
        with open(os.path.join(state_dir, "unrelated.json"), "w") as f:
            json.dump({"timeline": []}, f)
        orders[name] = [b["role"] for b in pm.load_blackboxes(state_dir)]
        assert pm.load_blackboxes(os.path.join(state_dir, "missing")) == []
    assert orders["torch"] == orders["jax"] == ["coordinator", "decode-0", "prefill-0"]


# -- postmortem reconstruction ------------------------------------------------


def _shift_ring(ring, delta: float) -> None:
    """Move a recorder's events into another monotonic epoch."""
    ring._ring = type(ring._ring)(
        ((entry[0], entry[1] + delta) + entry[2:] for entry in ring._ring),
        maxlen=ring._ring.maxlen)


def _write_crash_scene(name: str, state_dir: str) -> None:
    """The boxes a killed-mid-handoff run leaves behind."""
    _, Recorder, _, _, pm = PACKAGES[name]
    offsets = {"prefill-0": {"offset_s": 10.0, "uncertainty_s": 0.001, "samples": 4,
                             "accepted": 2},
               "decode-0": {"offset_s": -3.0, "uncertainty_s": 0.001, "samples": 4,
                            "accepted": 2}}
    coord_ring = Recorder(capacity=32)
    coord_ring.note("handoff_start", handoff_id="h9", trace="t-fatal")
    coord = pm.BlackBox(state_dir, "coordinator", timeline=coord_ring,
                        meta={"clock_offsets": offsets})
    prefill_ring = Recorder(capacity=32)
    prefill_ring.note("handoff_serialize", handoff_id="h9", trace="t-fatal", bytes=1024)
    _shift_ring(prefill_ring, -10.0)
    prefill = pm.BlackBox(state_dir, "prefill-0", timeline=prefill_ring)
    decode_ring = Recorder(capacity=32)
    time.sleep(0.002)
    decode_ring.note("decode_op", handoff_id="h9", trace="t-fatal")
    decode_ring.note("handoff_scatter", handoff_id="h9", trace="t-fatal")
    decode_ring.admit(0, "t-fatal", 16)
    _shift_ring(decode_ring, 3.0)
    decode = pm.BlackBox(state_dir, "decode-0", timeline=decode_ring)
    decode.flush()
    time.sleep(0.01)
    prefill.flush()
    coord.flush()


def test_postmortem_reconstructs_death(tmp_path, capsys):
    reports, traces = {}, {}
    for name in ("torch", "jax"):
        pm = PACKAGES[name][4]
        state_dir = str(tmp_path / name)
        os.makedirs(state_dir)
        _write_crash_scene(name, state_dir)
        boxes = pm.load_blackboxes(state_dir)
        report = pm.triage_report(boxes)
        assert "3 black box(es)" in report
        assert "likely first casualty: decode-0" in report
        assert "in-flight traces: t-fatal" in report
        trace = pm.merged_perfetto(boxes)
        json.loads(json.dumps(trace))
        assert trace["otherData"]["clock_offsets"] == {"prefill-0": 10.0, "decode-0": -3.0}
        assert {b["role"] for b in trace["otherData"]["boxes"]} == \
            {"coordinator", "prefill-0", "decode-0"}
        starts, ends = _arc_pair(trace)
        assert len(starts) == 1 and len(ends) == 1
        assert starts[0]["ts"] <= ends[0]["ts"]
        out_path = os.path.join(state_dir, "merged.json")
        assert pm.main([state_dir, "--out", out_path, "--last", "4"]) == 0
        assert "t-fatal" in capsys.readouterr().out
        with open(out_path) as f:
            assert json.load(f)["traceEvents"]
        # Stamps, pids, paths and the silence's seconds differ between the
        # two runs; the rest of the report must not.
        reports[name] = [re.sub(r"t=-?\d+\.\d+|os pid \d+|\[[^]]*\]|\d+\.\d+s", "_", ln)
                         for ln in report.splitlines()]
        traces[name] = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                        for e in trace["traceEvents"]]
    assert reports["torch"] == reports["jax"]
    assert traces["torch"] == traces["jax"]


def test_postmortem_empty_dir_exits_2(tmp_path, capsys):
    for name in ("torch", "jax"):
        assert PACKAGES[name][4].main([str(tmp_path)]) == 2
        assert "no black boxes" in capsys.readouterr().out


# -- live pool: trace propagation, merge, overhead gate -----------------------

FIELDS = dict(
    model="tiny-llama", dtype="float32", max_decode_slots=4,
    page_size=8, num_pages=128, max_seq_len=64,
    prefill_buckets=(16, 32), decode_block_steps=2,
    adaptive_block=False, max_new_tokens_cap=12,
    default_max_new_tokens=12, supervise=False,
    disagg_heartbeat_s=0.1, disagg_recovery_wait_s=10.0,
    blackbox_every=4,
)


def _config(**overrides) -> EngineConfig:
    return EngineConfig(**{**FIELDS, **overrides})


@pytest.fixture(scope="module")
def params():
    jparams = jt.init_params(jax.random.PRNGKey(7), j_get_config("tiny-llama"),
                             jax.numpy.float32)
    return params_from_numpy(jax.device_get(jparams))


def _run(pool, prompt: str, n: int = 10, **kw):
    request = GenRequest(prompt=prompt, max_new_tokens=n, **kw)
    pool.submit(request)
    tokens = []
    while True:
        kind, value = request.out.get(timeout=60)
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens, None, request
        else:
            return tokens, value, request


class _Stack:
    def __init__(self, cfg, params, decode_workers=1, prefill_workers=1, state_dir=None):
        self.workers = []
        for tier, count in ((PREFILL, prefill_workers), (DECODE, decode_workers)):
            for i in range(count):
                self.workers.append(WorkerServer(
                    cfg, tier=tier, replica=i, seed=7, params=params, device="cpu",
                    exit_mode="simulate", state_dir=state_dir).start())
        self.pool = DisaggPool.create(
            cfg, workers=[(w.tier, ("127.0.0.1", w.port)) for w in self.workers],
            state_dir=state_dir)

    def close(self):
        self.pool.shutdown()
        for worker in self.workers:
            worker.stop()


@pytest.fixture()
def stacks(params):
    opened = []

    def make(cfg=None, **kw) -> _Stack:
        stack = _Stack(cfg or _config(), params, **kw)
        opened.append(stack)
        return stack

    yield make
    for stack in opened:
        stack.close()


def _wait_for_clocks(pool, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(w.clock.offset is not None for w in pool.workers):
            return
        time.sleep(0.05)
    raise AssertionError("heartbeat never delivered a clock sample")


def test_trace_id_continuity_across_reroute(stacks):
    stack = stacks(decode_workers=2)
    _wait_for_clocks(stack.pool)
    faults.install("worker-exit=3@1:tier=decode:replica=0")
    trace = Span("gateway", trace_id="t-route")
    toks, err, req = _run(stack.pool, "kill test prompt", trace=trace)
    assert err is None and len(toks) == 10
    assert req.restarted is True
    notes = [e for e in stack.pool.timeline.events() if e["kind"] == "note"]
    by_kind: dict = {}
    for event in notes:
        by_kind.setdefault(event["note_kind"], []).append(event["attrs"])
    for kind in ("handoff_start", "handoff_ack", "handoff_abort"):
        assert by_kind.get(kind), f"missing {kind} note"
        assert all(a.get("trace") == "t-route" for a in by_kind[kind]), kind
    abort = by_kind["handoff_abort"][0]
    assert abort["handoff_id"] in {a.get("handoff_id") for a in by_kind["handoff_start"]}
    worker_notes = []
    for worker in stack.workers:
        worker_notes += [e for e in worker.engine.timeline.events() if e["kind"] == "note"]
    intake = [e["attrs"] for e in worker_notes
              if e["note_kind"] in ("prefill_op", "decode_op")]
    assert intake and all(a.get("trace") == "t-route" for a in intake)
    names = [c.name for c in trace.children]
    assert "handoff_ship" in names and "handoff_fetch" in names
    grafted = [c for c in trace.children if c.name.startswith("worker:")]
    assert grafted, f"no worker subtree grafted (children: {names})"
    child_names = {c.name for g in grafted for c in g.children}
    assert {"handoff_deserialize", "handoff_serialize"} <= child_names


def test_merged_perfetto_live_pool(stacks, tmp_path):
    """The live merge holds the coordinator's and both workers' process rows
    and a matched serialize→scatter arc; the coordinator's black box
    carries the clock offsets an offline merge needs."""
    stack = stacks(state_dir=str(tmp_path))
    _wait_for_clocks(stack.pool)
    toks, err, _ = _run(stack.pool, "hello disagg world", trace=Span("gateway",
                                                                        trace_id="t-merge"))
    assert err is None and len(toks) == 10
    trace = stack.pool.merged_perfetto()
    json.loads(json.dumps(trace))
    assert set(_rows(trace).values()) == {"polykey coordinator", "polykey prefill-0",
                                          "polykey decode-0"}
    starts, ends = _arc_pair(trace)
    assert {s["id"] for s in starts} & {e["id"] for e in ends}, "no matched arc"
    assert set(trace["otherData"]["clock_offsets"]) == {"prefill-0", "decode-0"}
    stack.pool.shutdown()
    boxes = tpostmortem.load_blackboxes(str(tmp_path))
    roles = {b["role"] for b in boxes}
    assert {"coordinator", "prefill-0", "decode-0"} <= roles
    coord = next(b for b in boxes if b["role"] == "coordinator")
    assert set(coord["meta"]["clock_offsets"]) == {"prefill-0", "decode-0"}
    offline = tpostmortem.merged_perfetto(boxes)
    assert offline["otherData"]["source"] == "postmortem"
    assert len(set(_rows(offline).values())) == 3


def test_pool_signal_windows_and_snapshot(stacks):
    stack = stacks()
    for prompt in ("hello disagg world", "kill test prompt"):
        toks, err, _ = _run(stack.pool, prompt)
        assert err is None
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        windows = stack.pool.signal_windows()
        if windows and any(w["handoffs"]["ok"] >= 2 for w in windows.values()):
            break
        time.sleep(0.05)
    windows = stack.pool.signal_windows()
    assert windows, "heartbeat never sampled the signal ring"
    label, window = next(iter(windows.items()))
    assert window["covered_s"] > 0
    assert window["handoffs"]["ok"] >= 2
    assert window["handoff_bytes"] > 0
    assert window["wire_bandwidth_bytes_per_s"] > 0
    assert window["handoff_ms_count"] >= 2
    assert window["handoff_ms_p95"] >= window["handoff_ms_p50"] > 0
    assert window["tier_faults"] == {PREFILL: 0, DECODE: 0}
    assert window["fault_rate_per_min"] == 0
    snap = signals_snapshot(stack.pool)
    assert snap["replicas"] == {}          # engines live out of process
    assert snap["pool"].keys() == windows.keys()
    assert set(snap["clock_offsets"]) == {"prefill-0", "decode-0"}


def test_blackbox_overhead_gate(stacks, tmp_path):
    """Checkpointing is observability only: greedy streams and the decode
    workers' lane shape are the same with black boxes on and off."""
    on = stacks(cfg=_config(blackbox_every=2), state_dir=str(tmp_path))
    off = stacks(cfg=_config(blackbox_every=0))
    streams_on, streams_off = {}, {}
    for prompt in ("hello disagg world", "kill test prompt"):
        toks, err, _ = _run(on.pool, prompt)
        assert err is None
        streams_on[prompt] = toks
        toks, err, _ = _run(off.pool, prompt)
        assert err is None
        streams_off[prompt] = toks
    assert streams_on == streams_off
    lanes = [[w.engine.stats().get("avg_lanes") for w in s.workers if w.tier == DECODE]
             for s in (on, off)]
    assert lanes[0] == lanes[1]
    assert tpostmortem.load_blackboxes(str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_postmortem_after_mid_stream_death(stacks, tmp_path):
    """Kill a decode worker mid-stream, then reconstruct its final ring —
    the fatal trace id included — from the black box alone."""
    state_dir = str(tmp_path)
    stack = stacks(cfg=_config(blackbox_every=2), decode_workers=2, state_dir=state_dir)
    _wait_for_clocks(stack.pool)
    faults.install("worker-exit=3@1:tier=decode:replica=0")
    trace = Span("gateway", trace_id="t-victim")
    toks, err, req = _run(stack.pool, "kill test prompt", trace=trace)
    assert err is None and len(toks) == 10 and req.restarted
    victim_box = tpostmortem.blackbox_path(state_dir, "decode-0")
    assert os.path.exists(victim_box)
    with open(victim_box) as f:
        box = json.load(f)
    fatal = [e for e in box["timeline"]
             if e["kind"] == "note" and e["note_kind"] == "decode_op"]
    assert fatal and fatal[-1]["attrs"]["trace"] == "t-victim"
    report = tpostmortem.triage_report(tpostmortem.load_blackboxes(state_dir))
    assert "t-victim" in report
    merged = {label: events for _, label, events in stack.pool.merged_timelines()}
    assert "decode-0" in merged
    assert any(e.get("note_kind") == "decode_op"
               and e.get("attrs", {}).get("trace") == "t-victim"
               for e in merged["decode-0"] if e["kind"] == "note")
