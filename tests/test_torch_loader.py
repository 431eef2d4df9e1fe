"""The port's checkpoint loader (polykey_tpu_torch/models/loader.py) on the
CPU, against the safetensors package and the JAX package's loader.

- The reader: every tensor byte-identical to the safetensors package's
  read, for F32, F16 and BF16 with `__metadata__` present; other dtypes
  are refused by name. chip_smoke.py's HF writer is read back the same.
- The importer: a JAX `init_params` tree (tiny-llama, tiny-mixtral,
  tiny-gemma) exported to HF layout with safetensors.numpy (one file, two
  shards, an index beside a stale file the index does not name, one F16
  file) and imported by both packages: the trees bit for bit after
  `params_from_numpy`, in float32 and bfloat16, and `forward_paged`
  within the model tests' 1e-4 on the logits.
- Quantize on load: int8 and int4 trees byte-identical to
  `quantize_params` over the plain import, and to the JAX package's.
- Engines: a tiny-gemma target from `checkpoint_path` and a smaller
  tiny-gemma draft from `draft_checkpoint_path`: greedy streams equal to
  the JAX bucketed engines' from the same paths, plain and spec, and the
  same `params_key`.
- Refusals: a path that is neither safetensors nor orbax, and a missing
  path, by name. An orbax directory (the JAX package's save_checkpoint)
  is read now (tests/test_torch_orbax.py holds the format).
"""

import dataclasses
import functools
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
from polykey_tpu.engine import kv_cache as jkv
from polykey_tpu.models import loader as jl
from polykey_tpu.models import quant as jq
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.engine import kv_cache as tkv
from polykey_tpu_torch.engine.config import EngineConfig
from polykey_tpu_torch.engine.engine import GenRequest, InferenceEngine
from polykey_tpu_torch.models import loader as tl
from polykey_tpu_torch.models import quant as tq
from polykey_tpu_torch.models import transformer as tt
from polykey_tpu_torch.models.config import get_config
from polykey_tpu_torch.models.interop import params_from_numpy
from polykey_tpu_torch.models.quant import QuantizedTensor

safetensors = pytest.importorskip("safetensors")
from safetensors import safe_open  # noqa: E402
from safetensors import numpy as st_np  # noqa: E402
from safetensors import torch as st_torch  # noqa: E402

torch.set_num_threads(2)

LOGIT_TOL = 1e-4        # tests/test_torch_model.py: float32 logits after two layers
FAMILIES = ["tiny-llama", "tiny-mixtral", "tiny-gemma"]
LAYOUTS = ["file", "shards", "index", "f16-file"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same(got, want, path="params"):
    """Trees equal bit for bit: keys, layers, dtypes, shapes and bytes."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, QuantizedTensor):
        assert isinstance(got, QuantizedTensor), path
        assert (got.bits, got.act_dtype) == (want.bits, want.act_dtype), path
        _same(got.q, want.q, f"{path}.q")
        _same(got.s, want.s, f"{path}.s")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert _bytes(got) == _bytes(want), path


# -- the reader -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_reader_matches_the_safetensors_package(tmp_path, dtype):
    rng = np.random.default_rng(0)
    shapes = {"model.embed_tokens.weight": (11, 6), "b": (7,), "c.d": (2, 3, 4),
              "scalar": (), "empty": (0, 4)}
    tensors = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for k, s in shapes.items()}
    path = str(tmp_path / "m.safetensors")
    meta = {"format": "pt", "seed": "0"}
    st_torch.save_file(tensors, path, metadata=meta)
    f = tl.SafetensorsFile(path)
    assert f.metadata == meta
    assert sorted(f.keys()) == sorted(tensors)
    with safe_open(path, framework="pt") as ref:
        for name in tensors:
            got, want = f.get(name), ref.get_tensor(name)
            assert got.dtype == want.dtype == dtype and got.shape == want.shape, name
            assert _bytes(got) == _bytes(want) == _bytes(tensors[name]), name


@pytest.mark.parametrize("bad", [torch.float64, torch.int32, torch.int8],
                         ids=["F64", "I32", "I8"])
def test_reader_refuses_other_dtypes_by_name(tmp_path, bad):
    path = str(tmp_path / "m.safetensors")
    st_torch.save_file({"ok": torch.ones(3), "x": torch.ones(2, 2, dtype=bad)}, path)
    f = tl.SafetensorsFile(path)
    assert f.get("ok").tolist() == [1.0, 1.0, 1.0]
    name = {torch.float64: "F64", torch.int32: "I32", torch.int8: "I8"}[bad]
    with pytest.raises(ValueError, match=f"'x' has dtype {name}"):
        f.get("x")


# -- HF checkpoints of the JAX package's weights ------------------------------

def _export_hf(params: dict, cfg) -> dict:
    """tests/test_loader_families.py's reverse of import_safetensors: the
    stacked [L(,E),in,out] tree → a flat HF state dict, linears [out, in]."""
    tensors = {}

    def emit(name, arr, transpose):
        arr = np.asarray(arr, dtype=np.float32)
        tensors[name] = np.ascontiguousarray(arr.T) if transpose else arr

    for key_path, (pattern, transpose) in jl._hf_layer_map(cfg).items():
        node = params["layers"]
        for k in key_path:
            node = node[k]
        for i in range(cfg.num_layers):
            if "{e}" in pattern:
                for e in range(cfg.num_experts):
                    emit(pattern.format(i=i, e=e), node[i, e], transpose)
            else:
                emit(pattern.format(i=i), node[i], transpose)
    emit("model.embed_tokens.weight", params["embed"], False)
    emit("model.norm.weight", params["final_norm"], False)
    if not cfg.tie_embeddings:
        emit("lm_head.weight", params["lm_head"], True)
    return tensors


@functools.lru_cache(maxsize=None)
def _jax_weights(model: str, seed: int = 3) -> dict:
    jcfg = j_get_config(model)
    return jax.device_get(jt.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32))


def _write(directory, model: str, layout: str, seed: int = 3) -> str:
    """The JAX weights of `model` as an HF checkpoint in `layout`; returns
    the path to load."""
    tensors = _export_hf(_jax_weights(model, seed), j_get_config(model))
    os.makedirs(directory, exist_ok=True)
    if layout in ("file", "f16-file"):
        if layout == "f16-file":
            tensors = {k: v.astype(np.float16) for k, v in tensors.items()}
        path = os.path.join(directory, "model.safetensors")
        st_np.save_file(tensors, path, metadata={"format": "np"})
        return path
    names = sorted(tensors)
    half = len(names) // 2
    shards = {"model-00001-of-00002.safetensors": names[:half],
              "model-00002-of-00002.safetensors": names[half:]}
    for fname, keys in shards.items():
        st_np.save_file({k: tensors[k] for k in keys}, os.path.join(directory, fname))
    if layout == "index":
        weight_map = {k: fname for fname, keys in shards.items() for k in keys}
        with open(os.path.join(directory, tl.INDEX_FILE), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
        # A file the index does not name must not be read.
        st_np.save_file({"model.norm.weight": np.zeros_like(tensors["model.norm.weight"])},
                        os.path.join(directory, "stale.safetensors"))
    return directory


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("model", FAMILIES)
def test_importer_gives_the_jax_tree_bit_for_bit(tmp_path, model, layout):
    """In float32 and bfloat16 (each tensor cast from the file's dtype as
    the reference casts it), and in float32 equal to the weights written."""
    path = _write(tmp_path / "ckpt", model, layout)
    jcfg, cfg = j_get_config(model), get_config(model)
    for jdtype, tdtype in DTYPES.values():
        want = params_from_numpy(jax.device_get(jl.import_safetensors(path, jcfg, jdtype)))
        got = tl.import_safetensors(path, cfg, tdtype)
        _same(got, want)
        assert ("lm_head" in got) == (not cfg.tie_embeddings)
    if layout != "f16-file":
        _same(tl.load_checkpoint(path, cfg, torch.float32),
              params_from_numpy(_jax_weights(model)))


def _forward_logits(params, cfg, jax_side: bool):
    """Prefill two right-padded prompts (bucket 16, page size 8), then two
    decode steps of fixed tokens: the sampled rows' float32 logits."""
    B, T, ps, N = 2, 16, 8, 9
    lens = np.array([11, 16])
    rng = np.random.default_rng(5)
    tokens = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    steps = rng.integers(3, cfg.vocab_size, (2, B, 1)).astype(np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if jax_side:
        fwd, unembed, arr = jt.forward_paged, jt.unembed, jnp.asarray
        paged = jkv.init_paged_kv(cfg, N, ps, jnp.float32)
    else:
        fwd, unembed, arr = tt.forward_paged, tt.unembed, torch.from_numpy
        paged = tkv.init_paged_kv(cfg, N, ps, torch.float32)
    h, paged = fwd(params, cfg, arr(tokens), arr(positions), paged, arr(tables))
    out = [np.asarray(unembed(params, cfg, h[np.arange(B), lens - 1]
                              if jax_side else h[torch.arange(B), torch.from_numpy(lens - 1)]))]
    for i, tok in enumerate(steps):
        pos = (lens + i).astype(np.int32)[:, None]
        h, paged = fwd(params, cfg, arr(tok), arr(pos), paged, arr(tables))
        out.append(np.asarray(unembed(params, cfg, h[:, 0])))
    return np.stack(out)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("model", FAMILIES)
def test_imported_forward_matches_jax(tmp_path, model, dtype):
    """Both packages' imports through their forward_paged, in float32 (a
    bfloat16 import upcast exactly on both sides)."""
    jdtype, tdtype = DTYPES[dtype]
    path = _write(tmp_path / "ckpt", model, "shards")
    jcfg, cfg = j_get_config(model), get_config(model)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jl.import_safetensors(path, jcfg, jdtype))
    tp = _up(tl.import_safetensors(path, cfg, tdtype))
    with torch.inference_mode():
        got = _forward_logits(tp, cfg, jax_side=False)
    want = _forward_logits(jp, jcfg, jax_side=True)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


def _up(node):
    """A port tree in float32 (exact from bfloat16)."""
    if isinstance(node, dict):
        return {k: _up(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_up(v) for v in node]
    return node.float()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", ["tiny-mixtral", "tiny-gemma"])
def test_quantize_on_load_is_quantize_params(tmp_path, model, bits):
    """A layer at a time as it is read: the tree of quantize_params over the
    whole import, byte for byte, and of the JAX package's quantize_params
    over its own import (embedding and lm_head int8 under int4)."""
    path = _write(tmp_path / "ckpt", model, "index")
    jcfg, cfg = j_get_config(model), get_config(model)
    got = tl.load_checkpoint(path, cfg, torch.bfloat16, quantize_bits=bits)
    _same(got, tq.quantize_params(tl.import_safetensors(path, cfg, torch.bfloat16), cfg,
                                  bits=bits))
    jqp = jq.quantize_params(jl.import_safetensors(path, jcfg, jnp.bfloat16), jcfg, bits=bits)
    _same(got, params_from_numpy(jax.device_get(jqp)))
    assert got["embed"].bits == 8 and got["layers"][0]["attn"]["wq"].bits == bits


def test_chip_smoke_writer_is_read_back_by_safetensors_and_both_loaders(tmp_path):
    """chip_smoke.py's own writer (the card has no safetensors package):
    two shards and an index as HF ships them; each tensor equal to the
    safetensors package's read of it, and the port's and the JAX
    package's imports equal the tree written."""
    import chip_smoke

    cfg = get_config("tiny-mixtral")
    params = params_from_numpy(_jax_weights("tiny-mixtral"))
    total = chip_smoke.write_hf_checkpoint(params, cfg, str(tmp_path))
    with open(tmp_path / tl.INDEX_FILE) as f:
        index = json.load(f)
    assert sorted(set(index["weight_map"].values())) == [
        "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    assert index["metadata"]["total_size"] == total
    hf = {n: (t.t() if tr else t) for n, t, tr in chip_smoke._hf_tensors(params, cfg)}
    assert sorted(hf) == sorted(index["weight_map"])
    for fname in set(index["weight_map"].values()):
        with safe_open(str(tmp_path / fname), framework="pt") as f:
            assert f.metadata() == {"format": "pt"}
            for name in f.keys():
                assert _bytes(f.get_tensor(name)) == _bytes(hf[name]), name
    _same(tl.load_checkpoint(str(tmp_path), cfg, torch.float32), params)
    jimport = jl.import_safetensors(str(tmp_path), j_get_config("tiny-mixtral"), jnp.float32)
    _same(params_from_numpy(jax.device_get(jimport)), params)


# -- engines from checkpoints -------------------------------------------------

FIELDS = dict(model="tiny-gemma", tokenizer="byte", dtype="float32", max_decode_slots=4,
              page_size=8, num_pages=64, max_seq_len=64, prefill_buckets=(16, 32),
              max_new_tokens_cap=32, default_max_new_tokens=8)
JAX_ONLY = dict(lookahead_blocks=1, compile_warmup=False, supervise=False,
                signals_interval_s=0)
PROMPTS = ["hello loader", "gemma from safetensors", "q", "x" * 45]


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


def test_engines_from_checkpoints_match_the_jax_engines(tmp_path, monkeypatch):
    """tiny-gemma from checkpoint_path and a smaller tiny-gemma draft
    (registered in both packages, as tests/test_torch_spec_engine.py does)
    from draft_checkpoint_path: the port's plain and spec engines' greedy
    streams equal the JAX bucketed engines' from the same paths, and each
    engine's params_key equals its JAX twin's."""
    from polykey_tpu.models import config as jcfg
    from polykey_tpu_torch.models import config as tcfg

    for mod in (jcfg, tcfg):
        monkeypatch.setitem(mod.MODEL_REGISTRY, "tiny-gemma-draft", dataclasses.replace(
            mod.TINY_GEMMA, name="tiny-gemma-draft", num_layers=1, num_heads=2,
            num_kv_heads=1, hidden_size=32, intermediate_size=64,
            query_pre_attn_scalar=16.0))
    target = _write(tmp_path / "target", "tiny-gemma", "shards", seed=0)
    draft = _write(tmp_path / "draft", "tiny-gemma-draft", "file", seed=2)
    spec = dict(draft_model="tiny-gemma-draft", spec_gamma=3,
                draft_checkpoint_path=draft)
    outs = {}
    for name, extra in (("plain", {}), ("spec", spec)):
        fields = dict(FIELDS, checkpoint_path=target, **extra)
        jeng = JInferenceEngine(JEngineConfig(**fields, **JAX_ONLY))
        try:
            want, jkey = _streams(jeng, JGenRequest), jeng._params_fingerprint(0)
        finally:
            jeng.shutdown()
        eng = InferenceEngine(EngineConfig(**fields), device="cpu")
        try:
            got, key = _streams(eng, GenRequest), eng._params_fingerprint(0)
            if name == "spec":
                assert eng.metrics.snapshot()["drafts_proposed"] > 0
                _same(eng.draft_params, params_from_numpy(_jax_weights("tiny-gemma-draft", 2)))
        finally:
            eng.shutdown()
        assert got == want, name
        assert key == jkey, name
        outs[name] = got
    assert outs["spec"] == outs["plain"]


# -- refusals -----------------------------------------------------------------

def test_an_orbax_checkpoint_is_refused_naming_the_roadmap_item(tmp_path):
    """The JAX package's own format (save_checkpoint writes orbax) is read
    by the port now (ROADMAP.md A.14 is done): the tree is the JAX one bit
    for bit. A path that is neither safetensors nor orbax is refused by
    name, by the loader and by the engine, naming what was looked for."""
    path = str(tmp_path / "orbax")
    jp = jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"), jnp.float32)
    jl.save_checkpoint(path, jp)
    _same(tl.load_checkpoint(path, get_config("tiny-llama"), torch.float32),
          params_from_numpy(jax.device_get(jp)))
    neither = tmp_path / "neither"
    neither.mkdir()
    (neither / "weights.bin").write_bytes(b"not a checkpoint")
    for target in (str(neither), str(neither / "weights.bin")):
        with pytest.raises(ValueError, match="neither safetensors .* nor orbax"):
            tl.load_checkpoint(target, get_config("tiny-llama"), torch.float32)
    with pytest.raises(ValueError, match="_METADATA"):
        InferenceEngine(EngineConfig(model="tiny-llama", dtype="float32", num_pages=16,
                                     checkpoint_path=str(neither)), device="cpu")


def test_a_missing_checkpoint_is_refused_by_name(tmp_path):
    missing = str(tmp_path / "no-such-checkpoint")
    with pytest.raises(FileNotFoundError, match="no-such-checkpoint"):
        tl.load_checkpoint(missing, get_config("tiny-llama"))
    with pytest.raises(FileNotFoundError, match="no-such-checkpoint"):
        InferenceEngine(EngineConfig(model="tiny-llama", dtype="float32", num_pages=16,
                                     draft_model="tiny-llama",
                                     draft_checkpoint_path=missing), device="cpu")
