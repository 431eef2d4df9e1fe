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
- orbax (the reference's `save_checkpoint` format): refused. Orbax and
  tensorstore are JAX-side libraries, and their on-disk layout is not
  read here (ROADMAP.md A.14); `save_checkpoint` is not ported for the
  same reason. Nothing is fetched: paths are local.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from .config import ModelConfig
from .quant import quantize, quantize_embed, quantize_tree

# safetensors dtype names read here, and the torch dtype of each.
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
INDEX_FILE = "model.safetensors.index.json"
ORBAX_ITEM = "ROADMAP.md A.14: orbax checkpoints"


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

    def keys(self) -> list:
        return list(self.entries)

    def get(self, name: str, device="cpu") -> torch.Tensor:
        """Tensor `name` in its stored dtype on `device`: its bytes copied
        once, straight from the mapped file to the device."""
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
        raw = torch.from_numpy(self._map[self._base + start:self._base + end])
        raw = raw.to(device) if torch.device(device).type != "cpu" else raw.clone()
        return raw.view(dtype).reshape(shape)


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
) -> dict:
    """Map a local HF safetensors checkpoint into the port's parameter
    tree on `device`, in `dtype` (each tensor cast on the device, as the
    reference's `jnp.asarray(t, dtype)`). A tied model has no lm_head.
    With `quantize_bits` (8 or 4) each layer is quantized once read, then
    the embedding and lm_head: `quantize_params(import_safetensors(...))`
    byte for byte."""
    files = [SafetensorsFile(f) for f in checkpoint_files(path)]
    where = {name: f for f in files for name in f.keys()}

    def get(name: str, transpose: bool) -> torch.Tensor:
        if name not in where:
            raise KeyError(f"checkpoint {path} has no tensor {name!r} "
                           f"(model {cfg.name})")
        t = where[name].get(name, device).to(dtype)
        return t.t().contiguous() if transpose else t

    layer_map = _hf_layer_map(cfg)
    layers = []
    for i in range(cfg.num_layers):
        layer: dict = {}
        for key_path, (pattern, transpose) in layer_map.items():
            if "{e}" in pattern:
                value = torch.stack([get(pattern.format(i=i, e=e), transpose)
                                     for e in range(cfg.num_experts)])
            else:
                value = get(pattern.format(i=i), transpose)
            node = layer
            for k in key_path[:-1]:
                node = node.setdefault(k, {})
            node[key_path[-1]] = value
        layers.append(layer if quantize_bits is None else quantize_tree(layer, quantize_bits))
    embed = get("model.embed_tokens.weight", transpose=False)
    params = {
        "embed": embed if quantize_bits is None else quantize_embed(embed),
        "layers": layers,
        "final_norm": get("model.norm.weight", transpose=False),
    }
    if not cfg.tie_embeddings:
        head = get("lm_head.weight", transpose=True)
        params["lm_head"] = head if quantize_bits is None else quantize(head, bits=8)
    return params


def load_checkpoint(
    path: str,
    cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    quantize_bits: Optional[int] = None,
) -> dict:
    """The served weights at `path`, dispatched as the reference's
    load_checkpoint: a safetensors path goes to `import_safetensors`; an
    orbax directory (the reference's `save_checkpoint`) is not read here
    and raises NotImplementedError; a missing path FileNotFoundError."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    if path.endswith(".safetensors") or glob.glob(os.path.join(path, "*.safetensors")):
        return import_safetensors(path, cfg, dtype, device, quantize_bits)
    raise NotImplementedError(
        f"checkpoint {path} is not safetensors: the reference's orbax format "
        f"is not ported to polykey_tpu_torch ({ORBAX_ITEM}); convert it to "
        "safetensors where JAX and orbax are installed")
