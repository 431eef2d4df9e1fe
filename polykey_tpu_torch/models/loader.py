"""Checkpoint loading for served weights (the reference's models/loader.py).

Formats:
- HF safetensors (`import_safetensors`): one `.safetensors` file, a
  directory of shards, or a directory with `model.safetensors.index.json`,
  holding a HuggingFace Llama, Mixtral or Gemma-2 state dict. It becomes
  the port's parameter tree (models/transformer.py: one dict per layer,
  weights `[in, out]`, expert stacks `[E, in, out]`). The files are read by
  this module's own reader (`SafetensorsFile`), not the `safetensors`
  package: each file is mapped, and each tensor is copied onto the target
  device alone and cast and transposed there, so the host never holds the
  tree. With `quantize_bits` each layer is quantized as soon as it is
  read (the tree of `quantize_params` over the whole import), so a
  checkpoint whose bf16 weights would not fit on the card loads in int8.
- orbax (the reference's `save_checkpoint` format: OCDBT + zarr v2 +
  zstd; `import_orbax`, `save_checkpoint`): read and written by
  models/orbax.py without orbax, tensorstore or a zstd package. The
  reference's tree stacks layers on a leading [L, ...] axis (experts
  [L, E, in, out]); each layer's slice becomes the port's layer dict, as
  models/interop.py maps it. `save_checkpoint` writes the port's tree in
  that layout, so the reference's `load_checkpoint` restores it; its zstd
  frames are raw blocks (models/orbax.py), larger on disk than the
  reference's level-1 frames.
Nothing is fetched: paths are local.
"""

from __future__ import annotations

import functools
import glob
import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from ..parallel.sharding import (
    P,
    _spec_for_path,
    layer_spec,
    local_bounds,
    local_slice,
    stage_run,
)
from . import orbax
from .config import ModelConfig
from .quant import (
    _QUANT_LEAVES,
    QuantizedTensor,
    int4_group,
    quantize,
    quantize_embed,
    quantize_rows,
)

# safetensors dtype names read here, and the torch dtype of each.
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
INDEX_FILE = "model.safetensors.index.json"
# A scale pass's chunk of rows on the device (fp32 bytes).
_SCAN_BYTES = 64 << 20
# zarr dtype names read and written for orbax, and the torch dtype of each.
ZARR_DTYPES = {"bfloat16": torch.bfloat16, "<f4": torch.float32, "<f2": torch.float16}


class SafetensorsFile:
    """One safetensors file, mapped: an 8-byte little-endian header length,
    a JSON header (per tensor `dtype`, `shape`, `data_offsets` into the
    buffer that follows; optional `__metadata__`), then the raw
    little-endian buffer. Tensors are read one at a time (`get`)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.metadata: Optional[dict] = header.pop("__metadata__", None)
        self.entries: dict = header
        self._base = 8 + n
        # Copy-on-write: a writable view, so torch takes it without a copy,
        # and nothing is ever written back to the file.
        self._map = np.memmap(path, dtype=np.uint8, mode="c")
        self.copied = 0

    def keys(self) -> list:
        return list(self.entries)

    def shape(self, name: str) -> tuple:
        return tuple(self.entries[name]["shape"])

    def get(self, name: str, device="cpu", index=None) -> torch.Tensor:
        """Tensor `name` in its stored dtype on `device`, its bytes copied
        once from the mapped file to the device. `index`, a (start, size)
        per dimension, copies that part alone: each dimension is narrowed
        on the mapping first, so no byte outside the part is read. A part
        that is a run of rows goes to the device straight from the
        mapping; a strided one (a range of columns) is gathered on the
        host first. `copied` counts the bytes copied."""
        entry = self.entries[name]
        dtype = SAFETENSORS_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(
                f"{self.path}: tensor {name!r} has dtype {entry['dtype']}; the "
                f"reader takes {', '.join(SAFETENSORS_DTYPES)}")
        start, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != int(np.prod(shape, dtype=np.int64)) * itemsize:
            raise ValueError(f"{self.path}: tensor {name!r} holds {end - start} bytes, "
                             f"not the {shape} {entry['dtype']} it declares")
        mapped = self._map[self._base + start:self._base + end].view(
            _NUMPY_OF_SIZE[itemsize]).reshape(shape)
        if index is not None:
            mapped = mapped[tuple(slice(a, a + n) for a, n in index)]
        if torch.device(device).type == "cpu":
            raw = torch.from_numpy(np.array(mapped, copy=True))
        else:
            raw = torch.from_numpy(np.ascontiguousarray(mapped)).reshape(mapped.shape)
            raw = raw.to(device)
        self.copied += raw.numel() * itemsize
        return raw.view(dtype)


# A numpy dtype of each item size, for the mapped bytes' views (bfloat16
# travels as its 16-bit words).
_NUMPY_OF_SIZE = {2: np.int16, 4: np.int32}


def checkpoint_files(path: str) -> list:
    """The safetensors files of `path`: itself, the files an index names,
    or every `*.safetensors` in the directory."""
    if not os.path.isdir(path):
        return [path]
    index = os.path.join(path, INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(path, fn) for fn in weight_map.values()})
    return sorted(glob.glob(os.path.join(path, "*.safetensors")))


# HF key mappings: the port's layer path → (HF tensor name pattern,
# transpose). HF stores linears [out, in]; the port uses [in, out], so
# every matmul weight transposes on import (norms don't).
_HF_ATTN_MAP = {
    ("attn", "wq"): ("model.layers.{i}.self_attn.q_proj.weight", True),
    ("attn", "wk"): ("model.layers.{i}.self_attn.k_proj.weight", True),
    ("attn", "wv"): ("model.layers.{i}.self_attn.v_proj.weight", True),
    ("attn", "wo"): ("model.layers.{i}.self_attn.o_proj.weight", True),
    ("ln1",): ("model.layers.{i}.input_layernorm.weight", False),
}


def _hf_layer_map(cfg: ModelConfig) -> dict:
    """Per-family HF tensor-name map covering all three served families.

    - Llama-3 (dense): mlp.{gate,up,down}_proj, post_attention_layernorm
      as the pre-MLP norm.
    - Mixtral (MoE): block_sparse_moe.gate is the router ([E, H] in HF →
      the port's [H, E]); experts.{e}.w1/w2/w3 map to gate/down/up and
      stack over the expert axis ([E, in, out]).
    - Gemma-2: four norms per layer — HF's post_attention_layernorm is the
      *post*-norm (post_ln1) and pre/post_feedforward_layernorm are
      ln2/post_ln2. HF Gemma RMSNorm stores w with gain = 1 + w, which is
      the port's storage convention for scale_embeddings models
      (transformer.init_params' norm_offset), so values copy as they are.
    """
    m = dict(_HF_ATTN_MAP)
    if cfg.use_post_norms:
        m[("ln2",)] = ("model.layers.{i}.pre_feedforward_layernorm.weight", False)
        m[("post_ln1",)] = ("model.layers.{i}.post_attention_layernorm.weight", False)
        m[("post_ln2",)] = ("model.layers.{i}.post_feedforward_layernorm.weight", False)
    else:
        m[("ln2",)] = ("model.layers.{i}.post_attention_layernorm.weight", False)
    if cfg.is_moe:
        m[("router",)] = ("model.layers.{i}.block_sparse_moe.gate.weight", True)
        m[("experts", "gate")] = (
            "model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight", True)
        m[("experts", "down")] = (
            "model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight", True)
        m[("experts", "up")] = (
            "model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight", True)
    else:
        m[("mlp", "gate")] = ("model.layers.{i}.mlp.gate_proj.weight", True)
        m[("mlp", "up")] = ("model.layers.{i}.mlp.up_proj.weight", True)
        m[("mlp", "down")] = ("model.layers.{i}.mlp.down_proj.weight", True)
    return m


def import_safetensors(
    path: str,
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    quantize_bits: Optional[int] = None,
    mesh=None,
    counts: Optional[dict] = None,
) -> dict:
    """Map a local HF safetensors checkpoint into the port's parameter
    tree on `device`, in `dtype` (each tensor cast on the device, as the
    reference's `jnp.asarray(t, dtype)`). A tied model has no lm_head.
    With `quantize_bits` (8 or 4) each layer is quantized once read, then
    the embedding and lm_head: `quantize_params(import_safetensors(...))`
    byte for byte.

    With `mesh` (a serving mesh) each tensor is cut to this rank's shard
    in the mapped file, before its bytes reach the device, as the serving
    specs cut it (parallel/sharding.py): only the pp stage's run of layers
    and the rank's E / ep experts are read; a column-parallel leaf (wq,
    wk, wv, gate, up, lm_head) and the vocab-split embedding are a run of
    the HF [out, in] tensor's rows, a row-parallel one (wo, down) a range
    of its columns. The tree is `shard_params` of the whole import, bit
    for bit, quantized too: where a leaf's quantization scale runs over
    the part of its contraction axis other ranks hold (an int8 wo or down
    at tp > 1, an int4 one whose groups tp does not split, the int8
    embedding's scale over the whole vocabulary), one pass over the whole
    tensor's rows, a chunk at a time on the device, takes the scale first.
    `counts` (a dict) gathers the bytes copied as shards ("copied") and
    read by those passes ("scanned")."""
    files = [SafetensorsFile(f) for f in checkpoint_files(path)]
    where = {name: f for f in files for name in f.keys()}
    tp = mesh.shape["tp"] if mesh is not None else 1
    scanned = [0]

    def entry(name: str) -> SafetensorsFile:
        if name not in where:
            raise KeyError(f"checkpoint {path} has no tensor {name!r} "
                           f"(model {cfg.name})")
        return where[name]

    def bounds(name: str, transpose: bool, spec) -> Optional[list]:
        """This rank's (start, size) along each port-layout dimension."""
        if mesh is None or spec is None:
            return None
        shape = entry(name).shape(name)
        return local_bounds(shape[::-1] if transpose else shape, spec, mesh)

    def get(name: str, transpose: bool, spec=None) -> torch.Tensor:
        """The tensor (or this rank's shard of it under `spec`, given in
        the port's layout) in `dtype`, transposed to the port's layout."""
        index = bounds(name, transpose, spec)
        if index is not None and transpose:
            index = index[::-1]
        t = entry(name).get(name, device, index).to(dtype)
        return t.t().contiguous() if transpose else t

    def absmax(name: str, transpose: bool, group: int = 0) -> torch.Tensor:
        """The whole tensor's fp32 absmax over the port's contraction axis
        (a row of the HF [out, in] tensor, or the embedding's column), per
        group of `group` entries for int4: [out], [G, out] or [H]."""
        f = entry(name)
        rows, cols = f.shape(name)
        step = max(1, _SCAN_BYTES // max(1, cols * 4))
        before, parts = f.copied, []
        for r in range(0, rows, step):
            n = min(step, rows - r)
            chunk = f.get(name, device, [(r, n), (0, cols)]).to(dtype).float().abs()
            if not transpose:                           # the embedding: over rows
                parts.append(chunk.amax(dim=0, keepdim=True))
            elif group:
                parts.append(chunk.reshape(n, cols // group, group).amax(dim=-1))
            else:
                parts.append(chunk.amax(dim=1))
        scanned[0] += f.copied - before
        out = torch.cat(parts)
        if not transpose:
            return out.amax(dim=0)
        return out.t().contiguous() if group else out

    def quantized(name: str, transpose: bool, spec, value: torch.Tensor,
                  bits: int) -> QuantizedTensor:
        """`value`, this rank's shard of `name`, quantized as the whole
        tensor is (models/quant.quantize_rows where the scale spans other
        ranks' rows)."""
        if spec is None or spec[-2] is None or tp == 1:
            return quantize(value, bits=bits)
        first = bounds(name, transpose, spec)[-2][0]
        cin = value.shape[-2] * tp
        if bits == 4:
            group = int4_group(cin)
            if (cin // group) % tp == 0:    # the groups split with the rows
                return quantize(value, bits=4)
            return quantize_rows(value, 4, absmax(name, transpose, group), first, group)
        return quantize_rows(value, 8, absmax(name, transpose))

    def leaf(i: int, key_path: tuple, pattern: str, transpose: bool):
        spec = layer_spec(key_path) if mesh is not None else None
        bits = None
        if quantize_bits is not None and key_path[-1] in _QUANT_LEAVES:
            bits = quantize_bits
        if "{e}" not in pattern:
            name = pattern.format(i=i)
            value = get(name, transpose, spec)
            return value if bits is None else quantized(name, transpose, spec, value, bits)
        experts, inner = range(cfg.num_experts), None
        if spec is not None:
            e0, ne = local_bounds((cfg.num_experts,), spec[:1], mesh)[0]
            experts, inner = range(e0, e0 + ne), P(*spec[1:])
        names = [pattern.format(i=i, e=e) for e in experts]
        stack = [get(name, transpose, inner) for name in names]
        if bits is None:
            return torch.stack(stack)
        if inner is None or inner[-2] is None or tp == 1:
            return quantize(torch.stack(stack), bits=bits)
        # Row-parallel experts: each expert's scale over its whole columns.
        parts = [quantized(name, transpose, inner, value, bits)
                 for name, value in zip(names, stack)]
        return QuantizedTensor(q=torch.stack([q.q for q in parts]),
                               s=torch.stack([q.s for q in parts]),
                               act_dtype=parts[0].act_dtype, bits=bits)

    layer_map = _hf_layer_map(cfg)
    layers = []
    for i in stage_run(cfg.num_layers, mesh):
        layer: dict = {}
        for key_path, (pattern, transpose) in layer_map.items():
            node = layer
            for k in key_path[:-1]:
                node = node.setdefault(k, {})
            node[key_path[-1]] = leaf(i, key_path, pattern, transpose)
        layers.append(layer)
    top = {k: P(*_spec_for_path((k,))) if mesh is not None else None
           for k in ("embed", "lm_head")}
    embed = get("model.embed_tokens.weight", False, top["embed"])
    if quantize_bits is not None:
        whole_vocab = None
        if mesh is not None and mesh.shape["tp"] > 1:
            whole_vocab = absmax("model.embed_tokens.weight", False)
        embed = quantize_embed(embed, whole_vocab)
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": get("model.norm.weight", transpose=False),
    }
    if not cfg.tie_embeddings:
        head = get("lm_head.weight", True, top["lm_head"])
        params["lm_head"] = head if quantize_bits is None else quantize(head, bits=8)
    if counts is not None:
        counts["copied"] = (counts.get("copied", 0) + sum(f.copied for f in files)
                            - scanned[0])
        counts["scanned"] = counts.get("scanned", 0) + scanned[0]
    return params


def _host_tensor(leaf: orbax.Leaf) -> torch.Tensor:
    """A decoded orbax leaf as a CPU tensor of its dtype and shape, on its
    buffer (no copy)."""
    dtype = ZARR_DTYPES.get(leaf.dtype)
    if dtype is None:
        raise ValueError(f"orbax leaf {'.'.join(leaf.path)} has dtype {leaf.dtype}; "
                         f"the reader takes {', '.join(ZARR_DTYPES)}")
    return torch.from_numpy(leaf.data).view(dtype).reshape(
        (len(leaf.rows),) + leaf.shape[1:] if leaf.shape else leaf.shape)


def import_orbax(
    path: str,
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    quantize_bits: Optional[int] = None,
    mesh=None,
    counts: Optional[dict] = None,
) -> dict:
    """The reference's orbax checkpoint at `path` (its `save_checkpoint`)
    as the port's parameter tree on `device`, in `dtype`: each leaf is
    decoded on the host a leaf at a time (models/orbax.read_tree), and each
    layer's slice of a stacked leaf goes onto the device alone and is cast
    there. With `quantize_bits` each layer is quantized once on the device,
    then the embedding and lm_head: `quantize_params` of the whole import,
    byte for byte.

    With `mesh` only the pp stage's run of layers is placed, and every
    tensor is cut to this rank's shard as the serving specs cut it
    (parallel/sharding.py): the rank decodes the chunks that hold its
    stage's layers (the whole of a leaf stored as one chunk, as the
    reference stores it) and copies only its shard to the device (a quantized leaf is quantized whole on
    the device first, so its scales are the whole tensor's). The tree is
    `shard_params` of the whole import, bit for bit. `counts` (a dict)
    gathers the bytes copied to the device ("copied") and decoded on the
    host ("decoded")."""
    run = stage_run(cfg.num_layers, mesh)
    want_top = {"embed", "final_norm"} | (set() if cfg.tie_embeddings else {"lm_head"})
    want_layer = set(_hf_layer_map(cfg))
    layers: list = [{} for _ in run]
    params: dict = {}
    copied = decoded = 0

    def place(host: torch.Tensor, spec, quantizer=None):
        """`host` on the device in `dtype`, quantized by `quantizer` when
        given, cut to this rank's shard under `spec(extra, leaf)`."""
        nonlocal copied
        if quantizer is None and mesh is not None:
            index = local_bounds(tuple(host.shape), spec((), host), mesh)
            for dim, (a, n) in enumerate(index):
                host = host.narrow(dim, a, n)
        host = host.contiguous()
        copied += host.numel() * host.element_size()
        value = host.to(device).to(dtype)
        if quantizer is None:
            return value
        value = quantizer(value)
        if mesh is None:
            return value
        return QuantizedTensor(q=local_slice(value.q, spec(("q",), value.q), mesh),
                               s=local_slice(value.s, spec(("s",), value.s), mesh),
                               act_dtype=value.act_dtype, bits=value.bits)

    # A pp stage decodes only its layers where the chunks allow it.
    for leaf in orbax.read_tree(path, rows=lambda keys: run if keys[0] == "layers" else None):
        decoded += leaf.data.nbytes
        host = _host_tensor(leaf)
        keys = leaf.path
        if keys[0] == "layers":
            key_path = keys[1:]
            if key_path not in want_layer:
                raise KeyError(f"checkpoint {path} has layer leaf {key_path} "
                               f"that model {cfg.name} does not")
            if leaf.shape[0] != cfg.num_layers:
                raise ValueError(f"checkpoint {path}: {'.'.join(keys)} stacks "
                                 f"{leaf.shape[0]} layers, model {cfg.name} has "
                                 f"{cfg.num_layers}")
            quantizer = None
            if quantize_bits is not None and key_path[-1] in _QUANT_LEAVES:
                quantizer = functools.partial(quantize, bits=quantize_bits)
            for j, i in enumerate(run):
                node = layers[j]
                for k in key_path[:-1]:
                    node = node.setdefault(k, {})
                node[key_path[-1]] = place(
                    host[i - leaf.rows.start], lambda extra, t, kp=key_path: layer_spec(kp + extra, t, mesh),
                    quantizer)
        else:
            (name,) = keys if len(keys) == 1 else (None,)
            if name not in want_top:
                raise KeyError(f"checkpoint {path} has leaf {keys} that model "
                               f"{cfg.name} does not")
            quantizer = None
            if quantize_bits is not None and name != "final_norm":
                quantizer = (quantize_embed if name == "embed"
                             else functools.partial(quantize, bits=8))
            params[name] = place(
                host, lambda extra, t, n=name: P(*_spec_for_path((n,) + extra, t, mesh)),
                quantizer)
        del host, leaf
    missing = sorted(want_top - set(params))
    missing += [p for p in sorted(want_layer) if layers and _at(layers[0], p) is None]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing} (model {cfg.name})")
    params["layers"] = layers
    if counts is not None:
        counts["copied"] = counts.get("copied", 0) + copied
        counts["decoded"] = counts.get("decoded", 0) + decoded
    return params


def _at(node: dict, key_path: tuple):
    """The leaf at `key_path` of a nested dict, None where there is none."""
    for k in key_path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def _walk(node: dict, prefix: tuple = ()):
    """(key path, tensor) of every leaf of a nested dict, keys sorted (the
    reference's tree order)."""
    for k in sorted(node):
        v = node[k]
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def save_checkpoint(path: str, params: dict) -> int:
    """Write the port's parameter tree `params` (unquantized) as the
    reference's orbax checkpoint at `path`, which must not exist: layers
    stacked on a leading [L, ...] axis, so the reference's
    `load_checkpoint` restores it with its `init_params` template. Each
    stacked leaf is streamed a chunk (a layer, or part of one) at a time
    through one host buffer (pinned when the tree is on the card): the
    tree is never joined on the device. Returns the bytes written."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} already exists")
    layers = params["layers"]
    leaves = [(("layers",) + p, [_at(layer, p) for layer in layers])
              for p, _ in _walk(layers[0])]
    leaves = sorted([((k,), params[k]) for k in params if k != "layers"] + leaves)
    specs, biggest = [], 0
    for keys, value in leaves:
        stacked = isinstance(value, list)
        first = value[0] if stacked else value
        if isinstance(first, QuantizedTensor) or not isinstance(first, torch.Tensor):
            raise TypeError(f"save_checkpoint writes unquantized tensors; {keys} is "
                            f"{type(first).__name__}")
        zdtype = {v: k for k, v in ZARR_DTYPES.items()}.get(first.dtype)
        if zdtype is None:
            raise TypeError(f"{keys} has dtype {first.dtype}; the writer takes "
                            f"{', '.join(map(str, ZARR_DTYPES.values()))}")
        shape = ((len(value),) if stacked else ()) + tuple(first.shape)
        chunks = orbax.chunk_shape(shape, first.element_size(), stacked)
        specs.append((keys, value, stacked, zdtype, shape, chunks, first.element_size()))
        biggest = max(biggest, int(np.prod(chunks, dtype=np.int64)) * first.element_size())
    on_card = any((v[0] if isinstance(v, list) else v).device.type == "cuda"
                  for _, v in leaves)
    buf = torch.empty(max(biggest, 1), dtype=torch.uint8, pin_memory=on_card)

    def reader(value, stacked: bool, shape: tuple, chunks: tuple, itemsize: int):
        def chunk(idx: tuple) -> memoryview:
            starts = [i * c for i, c in zip(idx, chunks)]
            valid = [min(c, s - a) for c, s, a in zip(chunks, shape, starts)]
            t = value[idx[0]] if stacked else value
            inner = (starts[1:], shape[1:]) if stacked else (starts, shape)
            at = int(np.ravel_multi_index(*inner)) * itemsize if inner[1] else 0
            count = int(np.prod(valid, dtype=np.int64)) * itemsize
            size = int(np.prod(chunks, dtype=np.int64)) * itemsize
            flat = t.contiguous().reshape(-1).view(torch.uint8)
            buf[:count].copy_(flat[at:at + count])
            buf[count:size].zero_()
            return memoryview(buf[:size].numpy())
        return chunk

    return orbax.write_tree(path, [
        orbax.WriteLeaf(keys, zdtype, shape, chunks,
                        reader(value, stacked, shape, chunks, itemsize))
        for keys, value, stacked, zdtype, shape, chunks, itemsize in specs])


def load_checkpoint(
    path: str,
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    quantize_bits: Optional[int] = None,
    mesh=None,
    counts: Optional[dict] = None,
) -> dict:
    """The served weights at `path`, dispatched as the reference's
    load_checkpoint: a safetensors path goes to `import_safetensors`, an
    orbax directory (the reference's `save_checkpoint`, recognised by its
    `_METADATA` or `manifest.ocdbt`) to `import_orbax`, both read as this
    rank's shard with `mesh`. A missing path raises FileNotFoundError; a
    path that is neither ValueError."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    if path.endswith(".safetensors") or glob.glob(os.path.join(path, "*.safetensors")):
        return import_safetensors(path, cfg, dtype, device, quantize_bits, mesh, counts)
    if orbax.is_checkpoint(path):
        return import_orbax(path, cfg, dtype, device, quantize_bits, mesh, counts)
    raise ValueError(
        f"checkpoint {path} is neither safetensors (a *.safetensors file, or a "
        f"directory of them or with {INDEX_FILE}) nor orbax (a directory with "
        f"_METADATA or {orbax.MANIFEST})")
