"""The port's weight-only quantization (polykey_tpu_torch/models/quant.py)
against the JAX package's, on the CPU.

`quantize` must give the reference's q and s byte for byte, from float32
and bfloat16 weights, int8 and int4 (a whole group of 128 and a group
shrunk to the contraction axis). The products (`dequantize`, `qdot`,
`qeinsum_expert`, `embed_lookup`, `unembed_logits`) are held to 1e-5 of
the JAX function at float32 (different summation orders). The quantized
trees of tiny-llama and tiny-mixtral, and `params_bytes`, must equal the
reference's, and the port's quantizing init (a layer at a time) must give
the tree of `quantize_params` over the whole init. Inputs come from numpy
at a seed.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from polykey_tpu.models import quant as jq
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.models import quant as tq
from polykey_tpu_torch.models import transformer as tt
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy, tensor_from_numpy

torch.set_num_threads(2)

TOL = 1e-5


def _w(shape, seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(dtype)


def _pair(w, bits):
    """(JAX QuantizedTensor, port QuantizedTensor) of numpy weight `w`."""
    return jq.quantize(jnp.asarray(w), bits=bits), tq.quantize(tensor_from_numpy(w), bits=bits)


def _bytes_equal(jqt, tqt):
    assert tqt.bits == jqt.bits and tqt.shape == tuple(jqt.shape)
    want_q, want_s = np.asarray(jqt.q), np.asarray(jqt.s)
    assert str(tqt.q.dtype).removeprefix("torch.") == want_q.dtype.name
    assert tqt.s.dtype == torch.float32 and want_s.dtype == np.float32
    np.testing.assert_array_equal(tqt.q.numpy(), want_q)
    np.testing.assert_array_equal(tqt.s.numpy().view(np.uint32), want_s.view(np.uint32))


CASES = [
    ((256, 48), 8),            # int8 per output channel
    ((3, 64, 40), 8),          # int8 expert stack [E, in, out]
    ((256, 48), 4),            # int4, two groups of 128
    ((96, 40), 4),             # int4, group shrunk to the whole axis (96 % 128)
    ((3, 256, 24), 4),         # int4 expert stack
]


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,bits", CASES, ids=[f"{s}-int{b}" for s, b in CASES])
def test_quantize_is_byte_identical(shape, bits, dtype):
    jqt, tqt = _pair(_w(shape, dtype=dtype), bits)
    _bytes_equal(jqt, tqt)
    assert tqt.dtype == (torch.float32 if dtype == np.float32 else torch.bfloat16)


def test_quantize_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="bits"):
        tq.quantize(torch.zeros(4, 4), bits=3)
    with pytest.raises(ValueError, match="even contraction"):
        tq.quantize(torch.zeros(5, 4), bits=4)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_and_qdot_match(bits):
    jqt, tqt = _pair(_w((256, 48)), bits)
    np.testing.assert_allclose(tq.dequantize(tqt, torch.float32).numpy(),
                               np.asarray(jq.dequantize(jqt, jnp.float32)), atol=TOL, rtol=0)
    x = _w((2, 5, 256), seed=1)
    np.testing.assert_allclose(tq.qdot(torch.from_numpy(x), tqt).numpy(),
                               np.asarray(jq.qdot(jnp.asarray(x), jqt)), atol=TOL, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pattern,e_axis,x_shape,w_shape", [
    ("bth,ehi->beti", 1, (2, 3, 64), (4, 64, 48)),     # moe_mlp's form
    ("ech,ehi->eci", 0, (4, 5, 64), (4, 64, 48)),      # the dispatch's form
], ids=["dense", "dispatch"])
def test_qeinsum_expert_matches(pattern, e_axis, x_shape, w_shape, bits):
    jqt, tqt = _pair(_w(w_shape), bits)
    x = _w(x_shape, seed=2)
    want = jq.qeinsum_expert(pattern, jnp.asarray(x), jqt, e_axis=e_axis)
    got = tq.qeinsum_expert(pattern, torch.from_numpy(x), tqt, e_axis=e_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_init(model, dtype):
    return jt.init_params(jax.random.PRNGKey(0), j_get_config(model), dtype)


def _quantized_trees(model, bits, dtype=jnp.float32):
    """(JAX quantized tree carried into the port, the port's quantize_params
    over the carried fp tree, the JAX quantized tree)."""
    jcfg = j_get_config(model)
    jp = _jax_init(model, dtype)
    jqp = jq.quantize_params(jp, jcfg, bits=bits)
    tqp = tq.quantize_params(params_from_numpy(jax.device_get(jp)), get_config(model),
                             bits=bits)
    return params_from_numpy(jax.device_get(jqp)), tqp, jqp


def test_embed_lookup_and_unembed_match():
    """The per-hidden-channel embedding: lookup, the tied unembedding (scale
    folded into the activation) and an untied int8 lm_head (scale after)."""
    _, tqp, jqp = _quantized_trees("tiny-llama", 8)
    tokens = np.random.default_rng(3).integers(0, 512, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tq.embed_lookup(tqp["embed"], torch.from_numpy(tokens)).numpy(),
        np.asarray(jq.embed_lookup(jqp["embed"], jnp.asarray(tokens))), atol=TOL, rtol=0)
    h = _w((2, 7, 64), seed=4)
    for leaf, tied in (("embed", True), ("lm_head", False)):
        want = jq.unembed_logits(jnp.asarray(h), jqp[leaf], tied=tied)
        got = tq.unembed_logits(torch.from_numpy(h), tqp[leaf], tied=tied)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def _walk(a, b, path=""):
    """Every leaf of two port trees equal, bit for bit."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _walk(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, f"{path}/{i}")
    elif isinstance(a, tq.QuantizedTensor):
        assert (a.bits, a.act_dtype, a.q.dtype) == (b.bits, b.act_dtype, b.q.dtype), path
        assert torch.equal(a.q, b.q) and torch.equal(a.s.view(torch.int32),
                                                     b.s.view(torch.int32)), path
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", ["tiny-llama", "tiny-mixtral"])
def test_quantize_params_tree_matches(model, bits):
    """The reference's quantized tree, carried across by params_from_numpy
    (QuantizedTensor leaves, expert stacks split per layer), equals the
    port's quantize_params over the same weights, leaf for leaf; lm_head
    and the embedding stay int8 under int4; params_bytes agrees."""
    carried, tqp, jqp = _quantized_trees(model, bits, jnp.bfloat16)
    _walk(tqp, carried)
    assert tqp["lm_head"].bits == 8 and tqp["embed"].bits == 8
    assert tqp["embed"].s.shape == (64,)
    layer = tqp["layers"][0]
    assert layer["attn"]["wq"].bits == bits
    if model == "tiny-mixtral":
        assert layer["experts"]["up"].bits == bits and layer["experts"]["up"].shape == (4, 64, 128)
        assert layer["router"].dtype == torch.bfloat16
    assert tq.params_bytes(tqp) == jq.params_bytes(jqp)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", ["tiny-llama", "tiny-mixtral", "tiny-gemma"])
def test_quantizing_init_equals_quantize_params(model, bits):
    """init_params(quantize_bits=...) draws and quantizes a layer at a time;
    from the same generator it gives quantize_params(init_params(...))."""
    cfg = get_config(model)
    whole = tt.init_params(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(7))
    want = tq.quantize_params(whole, cfg, bits=bits)
    got = tt.init_params(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(7),
                         quantize_bits=bits)
    _walk(got, want)
    assert tq.params_bytes(got) < 0.62 * tq.params_bytes(whole)


@pytest.mark.parametrize("bits,gate", [(8, 0.05), (4, 0.35)])
def test_quantized_forward_tracks_fp(bits, gate):
    """The reference's accuracy gate (tests/test_quant.py) on the port's
    paged forward: tiny-mixtral with dispatch, the mean relative hidden
    gap between quantized and fp weights under 0.05 (int8) / 0.35 (int4)."""
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv

    cfg = dataclasses.replace(get_config("tiny-mixtral"), moe_dispatch=True)
    params = tt.init_params(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    qparams = tq.quantize_params(params, cfg, bits=bits)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 16)))
    pos = torch.arange(16, dtype=torch.int32)[None].repeat(2, 1)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)

    def hidden(p):
        paged = init_paged_kv(cfg, 5, 8, torch.float32)
        return tt.forward_paged(p, cfg, tokens, pos, paged, tables)[0]

    h_fp, h_q = hidden(params), hidden(qparams)
    assert bool(torch.isfinite(h_q).all())
    rel = (h_fp - h_q).abs() / h_fp.abs().clamp_min(1.0)
    assert float(rel.mean()) < gate, float(rel.mean())


ENGINE_FIELDS = dict(
    model="tiny-llama", tokenizer="byte", dtype="float32", max_decode_slots=4,
    page_size=8, num_pages=64, max_seq_len=64, prefill_buckets=(16, 32),
    max_new_tokens_cap=32, default_max_new_tokens=8, quantize=True,
)
PROMPTS = ["hello", "short one", "a prompt for the 32 bucket", "x" * 45]


def _greedy(engine, make):
    requests = [make(prompt=p, max_new_tokens=10) for p in PROMPTS]
    for r in requests:
        engine.submit(r)
    out = []
    for r in requests:
        tokens = []
        while True:
            kind, value = r.out.get(timeout=60)
            if kind == "token":
                tokens.append(value)
            else:
                assert kind == "done", value
                break
        out.append(tokens)
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_streams_match_jax(bits):
    """tiny-llama served with quantize=True (int8, or int4 with
    quantize_bits=4), the fp32 weights quantized by each engine: four
    prompts at once, one of them chunked, give the JAX engine's tokens."""
    from polykey_tpu.engine.config import EngineConfig as JEngineConfig
    from polykey_tpu.engine.engine import GenRequest as JGenRequest
    from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine

    jp = _jax_init("tiny-llama", jnp.float32)
    fields = dict(ENGINE_FIELDS, quantize_bits=bits)
    jeng = JInferenceEngine(JEngineConfig(**fields, lookahead_blocks=1, compile_warmup=False,
                                          supervise=False, signals_interval_s=0), params=jp)
    try:
        want = _greedy(jeng, JGenRequest)
    finally:
        jeng.shutdown()
    teng = InferenceEngine(EngineConfig(**fields), params=params_from_numpy(jax.device_get(jp)),
                           device="cpu")
    try:
        got = _greedy(teng, GenRequest)
        stats = teng.stats()
    finally:
        teng.shutdown()
    assert got == want and all(len(t) == 10 for t in got)
    assert stats["quantize"] is True and stats["quantize_bits"] == bits
    assert stats["weight_bytes"] == tq.params_bytes(teng.params)
    assert isinstance(teng.params["layers"][0]["attn"]["wq"], tq.QuantizedTensor)
