"""The port's training path (polykey_tpu_torch.train) against the JAX
package's train step on the CPU.

Single-device: the loss at init, masking, and the loss on a padded batch
against the JAX function. Multi-rank (one 8-rank gloo group for the
module, tests/torch_ranks.py): four steps of make_train_step at dp=2 x
tp=2, at sp=2 with ring attention and at sp=2 with Ulysses, each beside
the JAX train step on the same mesh shape over the simulated CPU devices;
then one 8-rank dp=2 x pp=2 x tp=2 run whose loss must fall. The batch
masks a quarter of its targets at random, so the shards' mask counts
differ and only the global normalisation gives the JAX gradients.

Tolerances (fp32): each step's loss within a relative 1e-4 of the JAX
step's; the final parameters within 2 * lr * steps = 8e-4 of JAX's (Adam's
sign-like update on near-zero gradients turns fp32 noise into steps of up
to lr); the single-device loss within 1e-5 of JAX's.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from polykey_tpu.models import transformer as jtf
from polykey_tpu.models.config import TINY_LLAMA
from polykey_tpu.parallel.mesh import MeshConfig as JMeshConfig, create_mesh as j_create_mesh
from polykey_tpu.train import cross_entropy_loss as j_loss, make_train_step as j_make_train_step
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh
from polykey_tpu_torch.parallel.sharding import _spec_for_path, local_slice
from polykey_tpu_torch.train import cross_entropy_loss
from polykey_tpu_torch.train.train import default_optimizer

CFG = dataclasses.replace(TINY_LLAMA, hidden_size=128, intermediate_size=256, num_heads=8,
                          num_kv_heads=4, head_dim=16)
B, T, STEPS, LR = 4, 32, 4, 1e-4
RUNS = {                                    # mesh, ranks, sp_impl
    "dp2xtp2": (dict(dp=2, tp=2), range(0, 4), "ring"),
    "sp2-ring": (dict(sp=2), range(4, 6), "ring"),
    "sp2-ulysses": (dict(sp=2), range(6, 8), "ulysses"),
}
DEEP = dataclasses.replace(CFG, num_layers=4)    # dp=2 x pp=2 x tp=2 over 8 ranks


def _layout_mesh(shape: dict, rank: int) -> Mesh:
    dims = tuple(shape.get(a, 1) for a in AXIS_NAMES)
    return Mesh(np.arange(int(np.prod(dims))).reshape(dims), rank)


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, CFG.vocab_size, (B, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    targets[rs.rand(B, T) < 0.25] = -1
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return tokens, targets, positions


def _jax_train(params, mesh_shape, sp_impl, batch):
    n = int(np.prod(list(mesh_shape.values())))
    mesh = j_create_mesh(JMeshConfig(**mesh_shape), jax.devices()[:n])
    init_state, train_step, shard_batch = j_make_train_step(CFG, mesh, sp_impl=sp_impl)
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))   # the step donates it
    sharded = shard_batch(*batch)
    losses = []
    for _ in range(STEPS):
        state, loss = train_step(state, *sharded)
        losses.append(float(loss))
    return np.asarray(losses), params_from_numpy(jax.device_get(state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, JAX losses and final parameters per run)."""
    tmp = tmp_path_factory.mktemp("train")
    batch = _batch()
    np.savez(tmp / "batch.npz", tokens=batch[0], targets=batch[1], positions=batch[2])
    params = jax.device_get(jtf.init_params(jax.random.PRNGKey(0), CFG, jnp.float32))
    torch_ranks.save_tree(tmp / "params.npz", params)
    deep = jtf.init_params(jax.random.PRNGKey(0), DEEP, jnp.float32)
    torch_ranks.save_tree(tmp / "deep.npz", jax.device_get(deep))
    jobs = [{"kind": "train", "name": name, "mesh": mesh, "devices": list(ranks),
             "cfg": torch_ranks.config_fields(CFG), "sp_impl": impl, "steps": STEPS,
             "params": str(tmp / "params.npz"), "batch": str(tmp / "batch.npz")}
            for name, (mesh, ranks, impl) in RUNS.items()]
    jobs.append({"kind": "train", "name": "dp2xpp2xtp2", "mesh": dict(dp=2, pp=2, tp=2),
                 "devices": list(range(8)), "cfg": torch_ranks.config_fields(DEEP),
                 "steps": STEPS, "micro": 2, "params": str(tmp / "deep.npz"),
                 "batch": str(tmp / "batch.npz")})
    box = {}

    def ranks():
        try:
            box["results"] = torch_ranks.run(8, jobs, tmp / "ranks", timeout=240)
        except BaseException as e:          # re-raised below, on the test's thread
            box["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        refs = {name: _jax_train(params, mesh, impl, batch)
                for name, (mesh, _, impl) in RUNS.items()}
    finally:
        thread.join(300)
    assert not thread.is_alive(), "rank runner did not return"
    if "error" in box:
        raise box["error"]
    return box["results"], refs


# -- one device ----------------------------------------------------------------


def _port_params(seed=0):
    return params_from_numpy(jax.device_get(jtf.init_params(jax.random.PRNGKey(seed), CFG,
                                                            jnp.float32)))


def test_loss_is_near_uniform_at_init():
    tokens, targets, positions = (torch.from_numpy(a) for a in _batch())
    loss = float(cross_entropy_loss(_port_params(), CFG, tokens.long(), targets, positions))
    assert abs(loss - np.log(CFG.vocab_size)) < 1.0


def test_masked_positions_do_not_contribute():
    tokens, targets, positions = (torch.from_numpy(a) for a in _batch())
    loss = cross_entropy_loss(_port_params(), CFG, tokens.long(), torch.full_like(targets, -1),
                              positions)
    assert float(loss) == 0.0


def test_loss_matches_reference_on_a_padded_batch():
    batch = _batch(seed=3)
    want = float(j_loss(jtf.init_params(jax.random.PRNGKey(0), CFG, jnp.float32), CFG, *batch))
    tokens, targets, positions = (torch.from_numpy(a) for a in batch)
    got = float(cross_entropy_loss(_port_params(), CFG, tokens.long(), targets, positions))
    assert abs(got - want) < 1e-5, (got, want)


def test_sp_and_pp_together_are_refused():
    tokens, targets, positions = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(ValueError, match="mutually exclusive"):
        cross_entropy_loss(_port_params(), CFG, tokens.long(), targets, positions,
                           _layout_mesh({"sp": 2, "pp": 2}, 0))


def test_sp_override_mounts_only_over_sp():
    """make_sp_override (and the reference's alias make_ring_override) is
    None without an sp extent, names an unknown impl, and otherwise mounts
    the ring or Ulysses function."""
    from polykey_tpu_torch.models.transformer import make_ring_override, make_sp_override

    pos = torch.zeros(1, 4, dtype=torch.int32)
    assert make_sp_override(CFG, None, pos) is None
    assert make_ring_override(CFG, _layout_mesh({"tp": 2}, 0), pos) is None
    assert callable(make_ring_override(CFG, _layout_mesh({"sp": 2}, 0), pos))
    assert callable(make_sp_override(CFG, _layout_mesh({"sp": 2}, 0), pos, "ulysses"))
    with pytest.raises(ValueError, match="unknown sp attention impl"):
        make_sp_override(CFG, _layout_mesh({"sp": 2}, 0), pos, "tree")


def test_default_optimizer_is_the_reference_adamw():
    """optax.adamw(1e-4, weight_decay=0.01): b1 0.9, b2 0.999, eps 1e-8,
    decay on every leaf; the single-tensor loop on the CPU."""
    opt = default_optimizer([torch.zeros(2, requires_grad=True), torch.zeros(3, requires_grad=True)])
    assert isinstance(opt, torch.optim.AdamW)
    (group,) = opt.param_groups
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        1e-4, (0.9, 0.999), 1e-8, 0.01)
    assert group["foreach"] is False and not group["fused"] and len(group["params"]) == 2


# -- over ranks ----------------------------------------------------------------


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("name", list(RUNS))
def test_step_loss_follows_reference(runs, name, step):
    results, refs = runs
    want = refs[name][0][step]
    for r in RUNS[name][1]:
        got = results[r][f"{name}/losses"][step]
        assert abs(got - want) <= 1e-4 * abs(want), (name, r, step, got, want)


@pytest.mark.parametrize("name", list(RUNS))
def test_final_parameters_follow_reference(runs, name):
    """Every rank's shards after the steps against the same slices of the
    JAX state's parameters."""
    results, refs = runs
    mesh_shape, ranks, _ = RUNS[name]
    want_tree = torch_ranks.flat_params(refs[name][1])
    worst = 0.0
    for i, r in enumerate(ranks):
        mesh = _layout_mesh(mesh_shape, i)
        got = {k[len(name) + 7:]: v for k, v in results[r].items()
               if k.startswith(f"{name}/param.")}
        assert set(got) == set(want_tree)
        for key, value in got.items():
            path = tuple(p for p in key.split(".") if not p.isdigit())
            spec = _spec_for_path(path)
            want = local_slice(torch.from_numpy(want_tree[key]),
                               spec[1:] if path[0] == "layers" else spec, mesh).numpy()
            worst = max(worst, float(np.abs(value - want).max()))
    assert worst <= 2 * LR * STEPS, worst


@pytest.mark.parametrize("name", list(RUNS) + ["dp2xpp2xtp2"])
def test_ranks_agree_and_count_steps(runs, name):
    """Every rank reports the same global loss each step, and the step."""
    results, _ = runs
    ranks = list(RUNS[name][1]) if name in RUNS else list(range(8))
    first = results[ranks[0]][f"{name}/losses"]
    for r in ranks:
        np.testing.assert_array_equal(results[r][f"{name}/losses"], first)
        assert int(results[r][f"{name}/step"]) == STEPS


def test_dp_pp_tp_run_memorises_the_batch(runs):
    results, _ = runs
    losses = results[0]["dp2xpp2xtp2/losses"]
    assert np.all(np.isfinite(losses))
    assert abs(losses[0] - np.log(CFG.vocab_size)) < 1.0
    assert losses[-1] < losses[0]
