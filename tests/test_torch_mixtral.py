"""The Mixtral family (MoE layers) and quantized weights through the port's
model and engine, on the CPU, against the JAX package.

- `forward_paged` (prefill, then decode steps) and `forward_ragged` (a
  mixed stream) on tiny-mixtral, einsum-dense and with the
  capacity-bucketed dispatch: logits and hidden states within 1e-4 /
  2e-5 of the JAX functions at float32 (TOLs of tests/test_torch_model.py
  and tests/test_torch_ragged.py). The decode batch of 2 rows has a
  capacity of 1 a expert, so decode drops pairs; the padded prefill
  bucket and the ragged stream's padding rows take their shares.
- Greedy streams token-identical to the JAX bucketed engine: tiny-mixtral
  dense (four prompts at once; the port's bucketed and ragged engines),
  tiny-mixtral with the dispatch (two live requests on four slots, in two
  buckets: the idle lanes take capacity after them), and a tiny-mixtral
  target with a tiny-llama draft under `quantize=True` against the JAX
  spec engine. With the dispatch, a ragged stream's capacity depends on
  its width, so a ragged engine is held to the JAX forward_ragged above,
  not to the bucketed engine.
"""

import dataclasses
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import config as jconfig
from polykey_tpu.models import transformer as jt
from polykey_tpu_torch.engine import kv_cache as tkv
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.models import config as tconfig
from polykey_tpu_torch.models import transformer as tt
from polykey_tpu_torch.models.interop import params_from_numpy

torch.set_num_threads(2)

TOL = 2e-5
LOGIT_TOL = 1e-4
DISPATCH = "tiny-mixtral-dispatch"      # tiny-mixtral with moe_dispatch=True

FIELDS = dict(
    model="tiny-mixtral", tokenizer="byte", dtype="float32",
    max_decode_slots=4, page_size=8, num_pages=64, max_seq_len=64,
    prefill_buckets=(16, 32), max_new_tokens_cap=32, default_max_new_tokens=8,
)
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
PROMPTS = ["hello moe", "short one", "a prompt for the 32 bucket", "another longer prompt!"]


@pytest.fixture(scope="module", autouse=True)
def dispatch_model():
    """Both registries gain tiny-mixtral with the dispatch, for the engines."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jconfig, tconfig):
            cfg = dataclasses.replace(mod.get_config("tiny-mixtral"), name=DISPATCH,
                                      moe_dispatch=True)
            mp.setitem(mod.MODEL_REGISTRY, DISPATCH, cfg)
        yield


@pytest.fixture(scope="module")
def jax_params():
    return jt.init_params(jax.random.PRNGKey(0), jconfig.get_config("tiny-mixtral"),
                          jnp.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("model", ["tiny-mixtral", DISPATCH])
def test_forward_paged_matches_jax(model, jax_params):
    """Two right-padded prompts (bucket 16), then three decode steps: the
    sampled rows' logits and the KV pools."""
    jcfg, cfg = jconfig.get_config(model), tconfig.get_config(model)
    tp = params_from_numpy(jax.device_get(jax_params))
    B, T, ps, N = 2, 16, 8, 9
    prompt_lens = np.array([11, 16])
    tokens = np.random.default_rng(5).integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jpaged = jkv.init_paged_kv(jcfg, N, ps, jnp.float32)
    tpaged = tkv.init_paged_kv(cfg, N, ps, torch.float32)
    jh, jpaged = jt.forward_paged(jax_params, jcfg, jnp.asarray(tokens),
                                  jnp.asarray(positions), jpaged, jnp.asarray(tables))
    th, tpaged = tt.forward_paged(tp, cfg, _t(tokens), _t(positions), tpaged, _t(tables))
    rows = prompt_lens - 1
    jl = jt.unembed(jax_params, jcfg, jh[np.arange(B), rows])
    _close(tt.unembed(tp, cfg, th[torch.arange(B), _t(rows)]), jl, LOGIT_TOL)
    last = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(3):
        pos = (prompt_lens + step).astype(np.int32)[:, None]
        jh, jpaged = jt.forward_paged(jax_params, jcfg, jnp.asarray(last[:, None]),
                                      jnp.asarray(pos), jpaged, jnp.asarray(tables))
        th, tpaged = tt.forward_paged(tp, cfg, _t(last[:, None]), _t(pos), tpaged,
                                      _t(tables))
        jl = jt.unembed(jax_params, jcfg, jh[:, 0])
        _close(tt.unembed(tp, cfg, th[:, 0]), jl, LOGIT_TOL)
        last = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _close(tpaged.k[:, 1:], np.asarray(jpaged.k)[:, 1:], TOL)
    _close(tpaged.v[:, 1:], np.asarray(jpaged.v)[:, 1:], TOL)


@pytest.mark.parametrize("model", ["tiny-mixtral", DISPATCH])
def test_forward_ragged_matches_jax(model, jax_params):
    """Two decode singles and a 7-token prefill range, padded to 16 rows,
    over pools that hold the sequences' earlier KV: every in-sequence
    row's hidden state and the pools the pass wrote."""
    jcfg, cfg = jconfig.get_config(model), tconfig.get_config(model)
    tp = params_from_numpy(jax.device_get(jax_params))
    rng = np.random.default_rng(9)
    T, P = 16, 4
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0]], np.int32)
    tokens = rng.integers(3, cfg.vocab_size, T).astype(np.int32)
    positions = np.zeros(T, np.int32)
    positions[:2], positions[2:9] = [6, 9], np.arange(5, 12)
    tok_tables = np.zeros((T, P), np.int32)
    tok_tables[0], tok_tables[1], tok_tables[2:9] = tables
    ops = (tokens, positions, tok_tables, np.array([0, 1, 2, T], np.int32),
           np.array([1, 1, 7, 0], np.int32), np.array([7, 10, 12, 0], np.int32),
           np.concatenate([tables, np.zeros((1, P), np.int32)]))
    shape = (cfg.num_layers, 8, 8, cfg.num_kv_heads, cfg.head_dim)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    jpaged = jkv.init_paged_kv(jcfg, 8, 8, jnp.float32).replace(
        k=jnp.asarray(k0), v=jnp.asarray(v0))
    tpaged = tkv.PagedKV(k=_t(k0.copy()), v=_t(v0.copy()))
    jh, jpaged = jt.forward_ragged(jax_params, jcfg, *(jnp.asarray(a) for a in ops[:2]),
                                   jpaged, *(jnp.asarray(a) for a in ops[2:]))
    th, tpaged = tt.forward_ragged(tp, cfg, *(_t(a) for a in ops[:2]), tpaged,
                                   *(_t(a) for a in ops[2:]))
    _close(th[:9], np.asarray(jh)[:9], TOL)
    _close(tpaged.k[:, 1:], np.asarray(jpaged.k)[:, 1:], TOL)
    _close(tpaged.v[:, 1:], np.asarray(jpaged.v)[:, 1:], TOL)


def _collect(request, timeout=60.0):
    tokens, done, error = [], None, None
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            kind, value = request.out.get(timeout=deadline - time.monotonic())
        except queue.Empty:
            break
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            done = value
            break
        else:
            error = value
            break
    assert error is None and done is not None, error
    return tokens


def _streams(engine, make, prompts, max_new=12):
    requests = [make(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in requests:
        engine.submit(r)
    return [_collect(r) for r in requests]


def _jax_streams(prompts, params, draft_params=None, **fields):
    eng = JInferenceEngine(JEngineConfig(**{**FIELDS, **JAX_ONLY, **fields}),
                           params=params, draft_params=draft_params)
    try:
        return _streams(eng, JGenRequest, prompts)
    finally:
        eng.shutdown()


def _port_streams(prompts, params, draft_params=None, **fields):
    eng = InferenceEngine(
        EngineConfig(**{**FIELDS, **fields}),
        params=params_from_numpy(jax.device_get(params)), device="cpu",
        draft_params=None if draft_params is None
        else params_from_numpy(jax.device_get(draft_params)))
    try:
        return _streams(eng, GenRequest, prompts), eng.stats()
    finally:
        eng.shutdown()


def test_dense_moe_streams_match_jax_bucketed(jax_params):
    """Four prompts at once over both buckets, einsum-dense MoE: the port's
    bucketed and ragged engines give the JAX bucketed engine's tokens."""
    want = _jax_streams(PROMPTS, jax_params)
    got, stats = _port_streams(PROMPTS, jax_params)
    assert got == want and all(len(t) == 12 for t in got)
    assert stats["model"] == "tiny-mixtral" and stats["quantize"] is False
    ragged, _ = _port_streams(PROMPTS, jax_params, ragged_dispatch=True)
    assert ragged == want


def test_dispatch_moe_streams_match_jax_bucketed(jax_params):
    """Capacity-bucketed dispatch, two live requests on four slots (one a
    bucket): the padded buckets overflow experts and the idle decode lanes
    take capacity after the live ones, in both engines alike."""
    prompts = ["hello moe", "a prompt for the 32 bucket"]
    want = _jax_streams(prompts, jax_params, model=DISPATCH)
    got, _ = _port_streams(prompts, jax_params, model=DISPATCH)
    assert got == want and all(len(t) == 12 for t in got)


def test_quantized_spec_moe_streams_match_jax(jax_params):
    """A tiny-mixtral target with a tiny-llama draft (the JAX engine's own
    draft seed), both quantized int8 by the engine, gamma 3: the JAX spec
    engine's greedy tokens."""
    jd = jt.init_params(jax.random.PRNGKey(2), jconfig.get_config("tiny-llama"),
                        jnp.float32)
    spec = dict(draft_model="tiny-llama", spec_gamma=3, quantize=True)
    want = _jax_streams(PROMPTS, jax_params, jd, **spec)
    got, stats = _port_streams(PROMPTS, jax_params, jd, **spec)
    assert got == want
    assert stats["quantize"] is True and stats["quantize_bits"] == 8
    assert stats["spec_rounds"] > 0
