"""The port's model layers and paged forward pass against the JAX package's,
on the CPU, at float32.

Weights come from polykey_tpu.models.transformer.init_params and are carried
across with params_from_numpy; activations are made with numpy from a seed.
Tolerance: both sides compute in float32 with different summation orders
(XLA vs ATen), 1e-5 absolute on O(1) layer outputs and 1e-4 on logits after
two layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu.models import layers as jl
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine import kv_cache as tkv
from polykey_tpu_torch.models import layers as tl
from polykey_tpu_torch.models import quant as tq
from polykey_tpu_torch.models import transformer as tt
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy, tensor_from_numpy

torch.set_num_threads(2)

TOL = 1e-5
LOGIT_TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches(offset):
    x, w = _x((2, 5, 64)), _x((64,), seed=1)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    _close(tl.rms_norm(_t(x), _t(w), 1e-5, offset), want)


def test_rope_matches():
    x = _x((2, 7, 4, 16))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [40, 41, 42, 43, 100, 127, 3]], np.int32)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    _close(tl.rope(_t(x), _t(pos), 10_000.0), want)


@pytest.mark.parametrize("activation", ["silu", "gelu_tanh"])
def test_mlp_matches(activation):
    p = {"gate": _x((64, 128), 1) * 0.1, "up": _x((64, 128), 2) * 0.1,
         "down": _x((128, 64), 3) * 0.1}
    x = _x((2, 5, 64))
    want = jl.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), activation)
    got = tl.mlp({k: _t(v) for k, v in p.items()}, _t(x), activation)
    _close(got, want)


def test_qkv_project_matches():
    cfg = get_config("tiny-llama")
    p = {"wq": _x((64, 64), 1), "wk": _x((64, 32), 2), "wv": _x((64, 32), 3)}
    x = _x((2, 5, 64)) * 0.1
    want = jl.qkv_project({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), j_get_config("tiny-llama"))
    got = tl.qkv_project({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_quantized_weights_name_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="int8/int4 weights"):
        tq.qdot(torch.zeros(1, 4), np.zeros((4, 4), np.int8))


def _params(model: str, dtype=jnp.float32):
    jcfg = j_get_config(model)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg, dtype)
    return jcfg, jp, params_from_numpy(jax.device_get(jp))


def test_params_from_numpy_bf16_round_trip():
    _, jp, tp = _params("tiny-llama", jnp.bfloat16)
    want = np.asarray(jp["layers"]["attn"]["wq"][1])
    got = tp["layers"][1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    embed = np.asarray(jp["embed"])
    np.testing.assert_array_equal(
        tp["embed"].view(torch.int16).numpy(), embed.view(np.int16)
    )
    assert len(tp["layers"]) == 2
    back = tensor_from_numpy(np.ones(3, dtype=ml_dtypes.bfloat16), dtype=torch.float32)
    assert back.dtype == torch.float32 and back.tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-gemma"])
def test_forward_paged_prefill_then_decode_matches(model):
    """Prefill two right-padded prompts (bucket 16, page size 8), then three
    decode steps, through forward_paged and unembed on both sides: logits,
    and the KV pools the pass wrote."""
    jcfg, jp, tp = _params(model)
    cfg = get_config(model)
    B, T, ps, P, N = 2, 16, 8, 4, 9
    prompt_lens = np.array([11, 16])
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()

    jpaged = jkv.init_paged_kv(jcfg, N, ps, jnp.float32)
    tpaged = tkv.init_paged_kv(cfg, N, ps, torch.float32)
    jh, jpaged = jt.forward_paged(jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
                                  jpaged, jnp.asarray(tables))
    th, tpaged = tt.forward_paged(tp, cfg, _t(tokens), _t(positions), tpaged,
                                  _t(tables))
    rows = prompt_lens - 1
    jl_ = jt.unembed(jp, jcfg, jh[np.arange(B), rows])
    tl_ = tt.unembed(tp, cfg, th[torch.arange(B), _t(rows)])
    _close(tl_, jl_, LOGIT_TOL)

    last = np.asarray(jnp.argmax(jl_, -1)).astype(np.int32)
    for step in range(3):
        pos = (prompt_lens + step).astype(np.int32)[:, None]
        jh, jpaged = jt.forward_paged(jp, jcfg, jnp.asarray(last[:, None]),
                                      jnp.asarray(pos), jpaged, jnp.asarray(tables))
        th, tpaged = tt.forward_paged(tp, cfg, _t(last[:, None]), _t(pos), tpaged,
                                      _t(tables))
        jl_ = jt.unembed(jp, jcfg, jh[:, 0])
        tl_ = tt.unembed(tp, cfg, th[:, 0])
        _close(tl_, jl_, LOGIT_TOL)
        last = np.asarray(jnp.argmax(jl_, -1)).astype(np.int32)
    # Page 0 is the garbage page; every other page must hold the same KV.
    _close(tpaged.k[:, 1:], np.asarray(jpaged.k)[:, 1:])
    _close(tpaged.v[:, 1:], np.asarray(jpaged.v)[:, 1:])


def test_kv_pool_bytes_matches():
    jcfg, cfg = j_get_config("llama-3-8b"), get_config("llama-3-8b")
    assert tkv.kv_pool_bytes(cfg, 2048, 16, torch.bfloat16) == jkv.kv_pool_bytes(
        jcfg, 2048, 16, jnp.bfloat16
    )


def test_init_params_draws_like_the_reference():
    """Same tree, shapes and dtypes as the reference's init_params, and
    weights scaled by fan-in^-0.5 (std within 5%)."""
    jcfg, jp, _ = _params("tiny-llama", jnp.bfloat16)
    cfg = get_config("tiny-llama")
    gen = torch.Generator().manual_seed(0)
    tp = tt.init_params(cfg, torch.bfloat16, "cpu", gen)
    assert tp["embed"].shape == jp["embed"].shape
    assert ("lm_head" in tp) == ("lm_head" in jp)
    for name, arr in jp["layers"]["mlp"].items():
        got = tp["layers"][0]["mlp"][name]
        assert tuple(got.shape) == arr.shape[1:] and got.dtype == torch.bfloat16
        fan_in = arr.shape[1]
        assert abs(got.float().std().item() * fan_in ** 0.5 - 1.0) < 0.05
    big = dataclasses.replace(cfg, num_layers=1)
    assert len(tt.init_params(big, torch.float32, "cpu", gen)["layers"]) == 1
