"""The port's MoE layer (polykey_tpu_torch/ops/moe.py) against the JAX
package's ops/moe.py, on the CPU, at float32.

The router's combine matrix and expert choices, the einsum-dense layer and
the capacity-bucketed dispatch are held to 1e-5 of the reference (XLA and
ATen sum in other orders), over fp, int8 and int4 experts. At the tiny
sizes capacity overflows often (N = 8 tokens, k = 2, E = 4 give C = 5):
the dropped (token, choice) pairs must be the reference's, counted by an
independent loop here. Under ample capacity the dispatch equals the dense
form. Tied router logits go to the lower expert index, as jax.lax.top_k
sends them. Inputs come from numpy at a seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polykey_tpu.models import quant as jq
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu.ops import moe as jm
from polykey_tpu_torch.models import quant as tq
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.ops import moe as tm

torch.set_num_threads(2)

TOL = 1e-5
H, I, E = 64, 128, 4


def _layer(bits, seed=0):
    """(JAX layer params, port layer params): a router and an expert stack."""
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((H, E)) * H ** -0.5).astype(np.float32)
    experts = {
        "gate": (rng.standard_normal((E, H, I)) * H ** -0.5).astype(np.float32),
        "up": (rng.standard_normal((E, H, I)) * H ** -0.5).astype(np.float32),
        "down": (rng.standard_normal((E, I, H)) * I ** -0.5).astype(np.float32),
    }
    jexp = {k: jnp.asarray(v) for k, v in experts.items()}
    texp = {k: torch.from_numpy(v) for k, v in experts.items()}
    if bits:
        jexp = {k: jq.quantize(v, bits=bits) for k, v in jexp.items()}
        texp = {k: tq.quantize(v, bits=bits) for k, v in texp.items()}
    return ({"router": jnp.asarray(router), "experts": jexp},
            {"router": torch.from_numpy(router), "experts": texp})


def _h(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfgs(**kw):
    return (dataclasses.replace(j_get_config("tiny-mixtral"), **kw),
            dataclasses.replace(get_config("tiny-mixtral"), **kw))


def test_router_weights_match():
    jl, tl = _layer(0)
    jcfg, cfg = _cfgs()
    h = _h((2, 5, H))
    jc, ji = jm._router_weights(jl, jnp.asarray(h), jcfg)
    tc, ti = tm._router_weights(tl, torch.from_numpy(h), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=0)
    assert torch.allclose(tc.sum(-1), torch.ones(2, 5))


def test_router_ties_go_to_the_lower_index():
    """A zero router gives every expert the same logit: the reference picks
    experts 0 and 1, each at weight 1/2; so must the port."""
    jl, tl = _layer(0)
    jl["router"], tl["router"] = jnp.zeros((H, E)), torch.zeros(H, E)
    jcfg, cfg = _cfgs()
    h = _h((3, H))
    _, ji = jm._router_weights(jl, jnp.asarray(h), jcfg)
    tc, ti = tm._router_weights(tl, torch.from_numpy(h), cfg)
    assert np.asarray(ji).tolist() == ti.tolist() == [[0, 1]] * 3
    assert tc[0].tolist() == [0.5, 0.5, 0.0, 0.0]


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["fp", "int8", "int4"])
@pytest.mark.parametrize("dispatch", [False, True], ids=["dense", "dispatch"])
def test_moe_layer_matches(dispatch, bits):
    jl, tl = _layer(bits)
    jcfg, cfg = _cfgs()
    h = _h((2, 4, H))        # N = 8, capacity 5: some pairs overflow
    fn = "moe_mlp_dispatch" if dispatch else "moe_mlp"
    want = getattr(jm, fn)(jl, jnp.asarray(h), jcfg)
    got = getattr(tm, fn)(tl, torch.from_numpy(h), cfg)
    assert got.shape == (2, 4, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def _drops_by_loop(idx: np.ndarray, capacity: int) -> set:
    """The (token, choice) pairs past their expert's capacity, counted in
    token-major, choice-minor order."""
    used = [0] * E
    dropped = set()
    for n, row in enumerate(idx):
        for c, e in enumerate(row):
            if used[e] >= capacity:
                dropped.add((n, c))
            used[e] += 1
    return dropped


def test_capacity_overflow_drops_the_reference_pairs():
    """A router that sends most tokens to expert 0 and 1: the bucket
    overflows, the port keeps exactly the pairs the loop keeps, and the
    layer's output (where the drops show as missing contributions) equals
    the reference's."""
    jl, tl = _layer(0, seed=3)
    bias = np.zeros((H, E), np.float32)
    bias[:, :2] = 0.5
    router = np.asarray(jl["router"]) + bias
    jl["router"], tl["router"] = jnp.asarray(router), torch.from_numpy(router)
    jcfg, cfg = _cfgs()
    h = np.abs(_h((1, 12, H), seed=4))     # positive rows favour experts 0, 1
    N, k = 12, 2
    capacity = max(1, int(N * k / E * 1.25))
    _, idx = tm._router_weights(tl, torch.from_numpy(h.reshape(N, H)), cfg)
    slot, keep = tm._dispatch_slots(idx, E, capacity)
    want_drops = _drops_by_loop(idx.numpy(), capacity)
    got_drops = {(n, c) for n, c in zip(*np.nonzero(~keep.numpy()))}
    assert want_drops and got_drops == want_drops
    out = tm.moe_mlp_dispatch(tl, torch.from_numpy(h), cfg)
    ref = jm.moe_mlp_dispatch(jl, jnp.asarray(h), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    # Without the drops the output would be the dense layer's: it is not.
    dense = tm.moe_mlp(tl, torch.from_numpy(h), cfg)
    assert not torch.allclose(out, dense, atol=1e-3)


@pytest.mark.parametrize("bits", [0, 8], ids=["fp", "int8"])
def test_dispatch_equals_dense_under_ample_capacity(bits):
    _, tl = _layer(bits)
    _, cfg = _cfgs()
    h = torch.from_numpy(_h((2, 6, H)))
    # capacity_factor E / k: every expert can take every token.
    ample = tm.moe_mlp_dispatch(tl, h, cfg, capacity_factor=E / 2)
    torch.testing.assert_close(ample, tm.moe_mlp(tl, h, cfg), atol=TOL, rtol=0)
