"""The reference's orbax checkpoints read and written by the port
(polykey_tpu_torch/models/orbax.py over the port's codec, through
models/loader.py) on the CPU, with tensorstore and the JAX package as the
oracle in both directions:

- JAX `save_checkpoint` of tiny-llama, tiny-mixtral and tiny-gemma, in
  bfloat16 and float32: the port's `load_checkpoint` gives
  `params_from_numpy` of the JAX tree bit for bit;
- the port's `save_checkpoint` of the same trees: the JAX package's
  `load_checkpoint` restores the same arrays bit for bit;
- quantize on load (int8, int4) from either writer's directory: the tree
  is `quantize_params` of the plain read, byte for byte;
- engines: a tiny-gemma target from an orbax `checkpoint_path` and a
  smaller tiny-gemma draft from an orbax `draft_checkpoint_path` serve the
  JAX bucketed engines' greedy streams from the same directories;
- rank shards (layout meshes, as tests/test_torch_mesh_loader.py reads
  them): each rank's tree is `shard_params` of the whole read, bit for bit,
  and it copies exactly its shard's bytes;
- the format's corners, against tensorstore itself: a B+tree with interior
  nodes and inline and indirect values, a zarr array with edge chunks and
  a missing chunk (its fill value), the port's raw-block chunk frames;
- the writer writes nothing outside its directory and refuses an existing
  path.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import loader as jl
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.models import loader as tl
from polykey_tpu_torch.models import orbax
from polykey_tpu_torch.models.config import TINY_MIXTRAL, get_config
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.models.quant import QuantizedTensor, params_bytes, quantize_params
from polykey_tpu_torch.models.transformer import init_params
from polykey_tpu_torch.parallel.mesh import Mesh, MeshConfig
from polykey_tpu_torch.parallel.sharding import shard_params, stage_run

torch.set_num_threads(2)

FAMILIES = ["tiny-llama", "tiny-mixtral", "tiny-gemma"]
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, QuantizedTensor):
        assert isinstance(got, QuantizedTensor) and got.bits == want.bits, path
        assert got.act_dtype == want.act_dtype, path
        _same(got.q, want.q, f"{path}.q")
        _same(got.s, want.s, f"{path}.s")
    else:
        assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape), path
        assert _bytes(got) == _bytes(want), path


def _jax_same(got, want) -> None:
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (key, a), (_, b) in zip(flat_got, flat_want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


@pytest.fixture(scope="module")
def trees():
    """(family, dtype) -> a JAX tree on the host: init_params in float32,
    and its cast to bfloat16."""
    out = {}
    for f in FAMILIES:
        tree = jt.init_params(jax.random.PRNGKey(0), j_get_config(f), jnp.float32)
        for d, (jdtype, _) in DTYPES.items():
            out[f, d] = jax.device_get(jax.tree_util.tree_map(lambda a: a.astype(jdtype), tree))
    return out


@pytest.fixture(scope="module")
def jax_dirs(trees, tmp_path_factory):
    """(family, dtype) -> a JAX save_checkpoint directory of that tree."""
    root = tmp_path_factory.mktemp("jax-orbax")
    out = {}
    for (f, d), tree in trees.items():
        out[f, d] = str(root / f"{f}-{d}")
        jl.save_checkpoint(out[f, d], tree)
    return out


@pytest.fixture(scope="module")
def port_dirs(trees, tmp_path_factory):
    """(family, dtype) -> the port's save_checkpoint of the same tree."""
    root = tmp_path_factory.mktemp("port-orbax")
    out = {}
    for (f, d), tree in trees.items():
        out[f, d] = str(root / f"{f}-{d}")
        assert tl.save_checkpoint(out[f, d], params_from_numpy(tree)) > 0
    return out


CASES = [(f, d) for f in FAMILIES for d in DTYPES]
IDS = [f"{f}-{d}" for f, d in CASES]


@pytest.mark.parametrize("family,dtype", CASES, ids=IDS)
def test_port_reads_the_jax_checkpoint_bit_for_bit(trees, jax_dirs, family, dtype):
    counts = {}
    got = tl.load_checkpoint(jax_dirs[family, dtype], get_config(family), DTYPES[dtype][1],
                             counts=counts)
    want = params_from_numpy(trees[family, dtype])
    _same(got, want)
    assert counts["copied"] == counts["decoded"] == params_bytes(want)


@pytest.mark.parametrize("family,dtype", CASES, ids=IDS)
def test_jax_reads_the_port_checkpoint_bit_for_bit(trees, port_dirs, family, dtype):
    back = jl.load_checkpoint(port_dirs[family, dtype], j_get_config(family), DTYPES[dtype][0])
    _jax_same(back, trees[family, dtype])
    # And the port reads its own back.
    _same(tl.load_checkpoint(port_dirs[family, dtype], get_config(family), DTYPES[dtype][1]),
          params_from_numpy(trees[family, dtype]))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_quantize_on_load_is_quantize_params(jax_dirs, port_dirs, family, bits):
    cfg = get_config(family)
    for dirs in (jax_dirs, port_dirs):
        path = dirs[family, "bfloat16"]
        plain = tl.load_checkpoint(path, cfg, torch.bfloat16)
        got = tl.load_checkpoint(path, cfg, torch.bfloat16, quantize_bits=bits)
        _same(got, quantize_params(plain, cfg, bits=bits))


# -- engines from orbax checkpoints --------------------------------------------

FIELDS = dict(model="tiny-gemma", tokenizer="byte", dtype="float32", max_decode_slots=4,
              page_size=8, num_pages=64, max_seq_len=64, prefill_buckets=(16, 32),
              max_new_tokens_cap=32, default_max_new_tokens=8)
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
PROMPTS = ["hello orbax", "gemma from ocdbt", "q", "x" * 45]


def _streams(engine, make, max_new=10):
    reqs = [make(prompt=p, max_new_tokens=max_new) for p in PROMPTS]
    for r in reqs:
        engine.submit(r)
    outs = []
    for r in reqs:
        toks = []
        while True:
            kind, value = r.out.get(timeout=60)
            assert kind != "error", value
            if kind == "done":
                break
            toks.append(value)
        outs.append(toks)
    return outs


def test_engines_from_orbax_checkpoints_match_the_jax_engines(jax_dirs, tmp_path,
                                                              monkeypatch):
    """tiny-gemma from an orbax checkpoint_path (the JAX package wrote it)
    and a smaller tiny-gemma draft from an orbax draft_checkpoint_path (the
    port wrote it): the port's spec engine's greedy streams equal the JAX
    bucketed spec engine's from the same directories."""
    from polykey_tpu.models import config as jcfg
    from polykey_tpu_torch.models import config as tcfg

    for mod in (jcfg, tcfg):
        monkeypatch.setitem(mod.MODEL_REGISTRY, "tiny-gemma-draft", dataclasses.replace(
            mod.TINY_GEMMA, name="tiny-gemma-draft", num_layers=1, num_heads=2,
            num_kv_heads=1, hidden_size=32, intermediate_size=64,
            query_pre_attn_scalar=16.0))
    target, draft = jax_dirs["tiny-gemma", "float32"], str(tmp_path / "draft")
    jdraft = jax.device_get(jt.init_params(jax.random.PRNGKey(2),
                                           j_get_config("tiny-gemma-draft"), jnp.float32))
    tl.save_checkpoint(draft, params_from_numpy(jdraft))
    fields = dict(FIELDS, checkpoint_path=target, draft_model="tiny-gemma-draft",
                  spec_gamma=3, draft_checkpoint_path=draft)
    jeng = JInferenceEngine(JEngineConfig(**fields, **JAX_ONLY))
    try:
        want = _streams(jeng, JGenRequest)
    finally:
        jeng.shutdown()
    eng = InferenceEngine(EngineConfig(**fields), device="cpu")
    try:
        got = _streams(eng, GenRequest)
        assert eng.metrics.snapshot()["drafts_proposed"] > 0
        _same(eng.draft_params, params_from_numpy(jdraft))
        _same(eng.params, tl.load_checkpoint(target, get_config("tiny-gemma"), torch.float32))
    finally:
        eng.shutdown()
    assert got == want


# -- rank shards ---------------------------------------------------------------

WIDE = dataclasses.replace(get_config("tiny-llama"), name="tiny-llama-wide",
                           intermediate_size=512)
MESH_CASES = {"tp2": (WIDE, dict(tp=2)), "pp2xtp2": (WIDE, dict(pp=2, tp=2)),
              "ep2xtp2": (TINY_MIXTRAL, dict(ep=2, tp=2))}


@pytest.fixture(scope="module")
def mesh_dirs(tmp_path_factory):
    """model name -> (a port-written orbax directory, its bf16 tree)."""
    out = {}
    for cfg in {id(c): c for c, _ in MESH_CASES.values()}.values():
        params = init_params(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(5))
        path = str(tmp_path_factory.mktemp(cfg.name) / "ckpt")
        tl.save_checkpoint(path, params)
        out[cfg.name] = (path, params)
    return out


@pytest.mark.parametrize("bits", [None, 8], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_each_rank_reads_its_shard_of_the_whole(mesh_dirs, case, bits):
    cfg, axes = MESH_CASES[case]
    path, params = mesh_dirs[cfg.name]
    whole = tl.load_checkpoint(path, cfg, torch.bfloat16, quantize_bits=bits)
    config = MeshConfig(**axes)
    devices = np.arange(config.num_devices).reshape(config.shape)
    for rank in range(config.num_devices):
        mesh = Mesh(devices, rank)
        counts = {}
        got = tl.load_checkpoint(path, cfg, torch.bfloat16, quantize_bits=bits, mesh=mesh,
                                 counts=counts)
        _same(got, shard_params(whole, cfg, mesh), f"rank {rank}")
        # The port's writer chunks a layer at a time, so a rank decodes the
        # whole of the top leaves and its pp stage's layers, no others;
        # unquantized, it copies its shard only.
        stage = dict(params, layers=[params["layers"][i]
                                     for i in stage_run(cfg.num_layers, mesh)])
        assert counts["decoded"] == params_bytes(stage)
        if bits is None:
            assert counts["copied"] == params_bytes(shard_params(params, cfg, mesh))


def test_a_pp_rank_reads_its_stage_from_one_chunk_leaves(trees, jax_dirs):
    """The reference's files hold each stacked leaf as one chunk: a pp
    rank decodes the whole leaf and keeps its stage's layers, the same
    tree as `shard_params` of the whole read."""
    path = jax_dirs["tiny-llama", "bfloat16"]
    cfg = get_config("tiny-llama")
    whole = tl.load_checkpoint(path, cfg, torch.bfloat16)
    config = MeshConfig(pp=2)
    devices = np.arange(config.num_devices).reshape(config.shape)
    for rank in range(config.num_devices):
        mesh = Mesh(devices, rank)
        counts = {}
        got = tl.load_checkpoint(path, cfg, torch.bfloat16, mesh=mesh, counts=counts)
        _same(got, shard_params(whole, cfg, mesh), f"rank {rank}")
        assert counts["decoded"] == params_bytes(whole)


# -- the format's corners, against tensorstore ---------------------------------

def test_interior_nodes_and_inline_and_indirect_values(tmp_path):
    """A store tensorstore wrote with small nodes (a B+tree of several
    levels) and values both inline and in data files: every key and value
    is read back."""
    ts = pytest.importorskip("tensorstore")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    want = {f"key{i:03d}/{'x' * (i % 3)}".encode(): bytes([i % 256]) * (5 + 13 * (i % 4))
            for i in range(120)}
    with ts.Transaction() as txn:
        for k, v in want.items():
            kv.with_transaction(txn)[k] = v
    got = orbax.read_store(str(tmp_path))
    assert {k: v if isinstance(v, bytes) else v.read() for k, v in got.items()} == want
    assert any(not isinstance(v, bytes) for v in got.values())


def test_edge_chunks_and_a_missing_chunk(tmp_path):
    """A zarr v2 array over OCDBT that tensorstore wrote with chunks that
    do not divide its shape and one chunk never written: read_tree gives
    tensorstore's own read, the missing chunk as the fill value."""
    ts = pytest.importorskip("tensorstore")
    kvstore = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    rng = np.random.default_rng(4)
    for name, dtype, fill in (("a.w", "<f4", 1.5), ("b", "<f2", None)):
        arr = ts.open({"driver": "zarr", "kvstore": dict(kvstore, path=f"{name}/"),
                       "metadata": {"shape": [10, 6], "chunks": [4, 4], "dtype": dtype,
                                    "fill_value": fill, "compressor": {"id": "zstd",
                                                                       "level": 3}},
                       "create": True}).result()
        arr[:8, :].write(rng.standard_normal((8, 6)).astype(dtype)).result()
    (tmp_path / "_METADATA").write_text(json.dumps({"tree_metadata": {
        repr(keys): {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                     "value_metadata": {"value_type": "jax.Array"}}
        for keys in (("a", "w"), ("b",))}}))
    leaves = list(orbax.read_tree(str(tmp_path)))
    assert [leaf.path for leaf in leaves] == [("a", "w"), ("b",)]
    for leaf, name in zip(leaves, ("a.w", "b")):
        want = ts.open({"driver": "zarr", "kvstore": dict(kvstore, path=f"{name}/")}
                       ).result().read().result()
        got = leaf.data.view(want.dtype).reshape(leaf.shape)
        np.testing.assert_array_equal(got, want)
    assert (leaves[0].data.view(np.float32).reshape(10, 6)[8:] == 1.5).all()


def test_port_chunks_are_raw_block_frames(port_dirs):
    """The port writes no compressed block: each chunk is a zstd frame of
    raw blocks (header byte 0xC0: an 8-byte content size, a window)."""
    store = orbax.read_store(port_dirs["tiny-llama", "bfloat16"])
    frames = [v if isinstance(v, bytes) else v.read()
              for k, v in store.items() if not k.endswith(b".zarray")]
    assert frames and all(f[:5] == bytes.fromhex("28b52ffdc0") for f in frames)


def test_the_writer_stays_in_its_directory_and_refuses_an_existing_path(trees, tmp_path):
    params = params_from_numpy(trees["tiny-llama", "float32"])
    parent = tmp_path / "parent"
    parent.mkdir()
    target = parent / "ckpt"
    tl.save_checkpoint(str(target), params)
    assert sorted(os.listdir(parent)) == ["ckpt"]
    assert sorted(os.listdir(target)) == ["_CHECKPOINT_METADATA", "_METADATA", "_sharding",
                                          "array_metadatas", "d", "manifest.ocdbt",
                                          "ocdbt.process_0"]
    before = sorted(os.walk(target))
    with pytest.raises(FileExistsError):
        tl.save_checkpoint(str(target), params)
    assert sorted(os.walk(target)) == before
    with pytest.raises(TypeError, match="unquantized"):
        tl.save_checkpoint(str(parent / "q"), quantize_params(params, bits=8))
