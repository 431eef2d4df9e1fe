"""Checkpoints read as a rank's shard (polykey_tpu_torch/models/loader.py
with `mesh=`) on the CPU.

A port `init_params` tree is written as HF ships a checkpoint
(chip_smoke.py's writer: two safetensors files and an index) and read by
every rank of a layout mesh (the rank's coordinates only: reading needs
no process group), at tp=2, tp=4, ep=2, pp=2 and their products, in
bfloat16, int8 and int4. Checks:

- each rank's tree equals `shard_params` of the whole read, bit for bit
  (quantized: of the whole read quantized on load), so the scales of
  row-parallel leaves, which run over other ranks' rows, are the whole
  weight's;
- each rank copies exactly its shard's bytes (the loader's `copied`
  count against the bytes of the sharded float32 tree), and only the
  quantized reads whose scale spans other ranks' rows pass over the
  whole tensor ("scanned");
- the sliced `SafetensorsFile.get` copies its part alone.

The engines that read a checkpoint over a gloo mesh are held to the JAX
engine in tests/test_torch_mesh_serving.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from polykey_tpu_torch.models import loader as tl
from polykey_tpu_torch.models.config import TINY_GEMMA, TINY_LLAMA, TINY_MIXTRAL
from polykey_tpu_torch.models.quant import QuantizedTensor, params_bytes
from polykey_tpu_torch.models.transformer import init_params
from polykey_tpu_torch.parallel.mesh import Mesh, MeshConfig
from polykey_tpu_torch.parallel.sharding import shard_params

torch.set_num_threads(2)

# Wide enough that int4's 128-row groups split over tp (down: 512 rows,
# four groups) beside leaves whose one group tp cannot split (wo: 64 rows).
WIDE = dataclasses.replace(TINY_LLAMA, name="tiny-llama-wide", intermediate_size=512)
MODELS = {"tiny-llama-wide": WIDE, "tiny-mixtral": TINY_MIXTRAL, "tiny-gemma": TINY_GEMMA}
CASES = {   # name -> (model, mesh axes)
    "tp2": ("tiny-llama-wide", dict(tp=2)),
    "tp4": ("tiny-llama-wide", dict(tp=4)),
    "pp2": ("tiny-llama-wide", dict(pp=2)),
    "pp2xtp2": ("tiny-llama-wide", dict(pp=2, tp=2)),
    "ep2": ("tiny-mixtral", dict(ep=2)),
    "ep2xtp2": ("tiny-mixtral", dict(ep=2, tp=2)),
    "gemma-tp2": ("tiny-gemma", dict(tp=2)),
}
LOADS = {"bfloat16": (torch.bfloat16, None), "int8": (torch.bfloat16, 8),
         "int4": (torch.bfloat16, 4)}


def _meshes(axes: dict) -> list:
    config = MeshConfig(**axes)
    devices = np.arange(config.num_devices).reshape(config.shape)
    return [Mesh(devices, r) for r in range(config.num_devices)]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """model -> (checkpoint directory, the float32 tree written)."""
    out = {}
    for name, cfg in MODELS.items():
        gen = torch.Generator().manual_seed(7)
        params = init_params(cfg, torch.float32, "cpu", gen)
        directory = tmp_path_factory.mktemp(name)
        chip_smoke.write_hf_checkpoint(params, cfg, str(directory))
        out[name] = (str(directory), params)
    return out


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, QuantizedTensor):
        assert isinstance(got, QuantizedTensor) and got.bits == want.bits, path
        _same(got.q, want.q, f"{path}.q")
        _same(got.s, want.s, f"{path}.s")
    else:
        assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape), path
        assert _bytes(got) == _bytes(want), path


@pytest.mark.parametrize("load", list(LOADS))
@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_reads_the_shard_of_the_whole_read(checkpoints, case, load):
    model, axes = CASES[case]
    cfg = MODELS[model]
    path, _ = checkpoints[model]
    dtype, bits = LOADS[load]
    whole = tl.load_checkpoint(path, cfg, dtype, quantize_bits=bits)
    whole_f32 = tl.load_checkpoint(path, cfg, torch.float32)
    tp = axes.get("tp", 1)
    for mesh in _meshes(axes):
        counts = {}
        got = tl.load_checkpoint(path, cfg, dtype, quantize_bits=bits, mesh=mesh,
                                 counts=counts)
        _same(got, shard_params(whole, cfg, mesh), f"rank {mesh.rank}")
        # The file holds float32: a rank copies its float32 shard's bytes.
        assert counts["copied"] == params_bytes(shard_params(whole_f32, cfg, mesh))
        assert (counts["scanned"] > 0) == (bits is not None and tp > 1), counts


def test_a_rank_copies_a_fraction_of_the_whole(checkpoints):
    """tp=2: a rank's bytes are its half of every split leaf and the
    replicated rest, well under the whole checkpoint's."""
    path, params = checkpoints["tiny-llama-wide"]
    whole = params_bytes(params)
    for mesh in _meshes(dict(tp=2)):
        counts = {}
        tl.load_checkpoint(path, WIDE, torch.bfloat16, mesh=mesh, counts=counts)
        assert whole / 2 <= counts["copied"] < 0.6 * whole, (counts, whole)


def test_sliced_get_copies_its_part_alone(checkpoints):
    """A run of rows and a range of columns of one HF tensor: equal to the
    whole tensor's part, and `copied` counts the part's bytes only."""
    path, _ = checkpoints["tiny-llama-wide"]
    files = [tl.SafetensorsFile(f) for f in tl.checkpoint_files(path)]
    name = "model.layers.1.mlp.down_proj.weight"       # [64, 512]
    f = next(f for f in files if name in f.keys())
    whole = f.get(name)
    before = f.copied
    rows = f.get(name, index=[(8, 16), (0, 512)])
    cols = f.get(name, index=[(0, 64), (256, 128)])
    assert torch.equal(rows, whole[8:24]) and torch.equal(cols, whole[:, 256:384])
    assert cols.is_contiguous()
    assert f.copied - before == (16 * 512 + 64 * 128) * 4
