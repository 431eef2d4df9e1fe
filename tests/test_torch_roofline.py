"""The port's roofline accounting (engine/roofline.py) against the JAX
package's: every public function gives the same numbers for every
registry model, KV dtype and quantize setting; `grade` gives the same
scorecard with no chip and with a ChipSpec passed; `detect_chip` maps only
the H100 SXM's reported name, and gives None on the CPU."""

import dataclasses

import pytest

from polykey_tpu.engine import roofline as jroof
from polykey_tpu.models import config as jconfig
from polykey_tpu_torch.engine import roofline as troof
from polykey_tpu_torch.models import config as tconfig

MODELS = sorted(jconfig.MODEL_REGISTRY)
QUANT = [(False, 8), (True, 8), (True, 4)]


def test_registries_match():
    assert sorted(tconfig.MODEL_REGISTRY) == MODELS


@pytest.mark.parametrize("model", MODELS)
def test_geometry_functions_equal_the_reference(model):
    jc, tc = jconfig.get_config(model), tconfig.get_config(model)
    for dtype in ("bfloat16", "float32"):
        for quantize, bits in QUANT:
            for lanes in (1.0, 3.0, 64.0):
                assert troof.weight_read_bytes(tc, dtype, quantize, bits, lanes) == \
                    jroof.weight_read_bytes(jc, dtype, quantize, bits, lanes)
            assert troof.weight_resident_bytes(tc, dtype, quantize, bits) == \
                jroof.weight_resident_bytes(jc, dtype, quantize, bits)
    for kv in ("bfloat16", "float32", "int8"):
        assert troof.kv_bytes_per_token(tc, kv) == jroof.kv_bytes_per_token(jc, kv)
        for pages, page_size in ((1, 16), (97, 16), (4096, 32)):
            assert troof.kv_pool_bytes_split(tc, pages, page_size, kv) == \
                jroof.kv_pool_bytes_split(jc, pages, page_size, kv)
            assert troof.kv_pool_bytes_spec(tc, pages, page_size, kv) == \
                jroof.kv_pool_bytes_spec(jc, pages, page_size, kv)
    for ctx in (0.0, 1.0, 511.5, 8192.0):
        assert troof.decode_flops_per_token(tc, ctx) == jroof.decode_flops_per_token(jc, ctx)
    for p in (1, 128, 1500):
        assert troof.prefill_flops(tc, p) == jroof.prefill_flops(jc, p)


def _as_reference(spec):
    return None if spec is None else jroof.ChipSpec(*dataclasses.astuple(spec))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("chip", [None, troof.CHIP_SPECS["h100-sxm"],
                                  troof.ChipSpec("other", 1e15, 2e12, 40e9)],
                         ids=["no-chip", "h100", "passed-spec"])
def test_grade_equals_the_reference(model, chip):
    draft = {"llama-3-8b": "llama-3.2-1b", "gemma-2-27b": "gemma-2-2b"}.get(model)
    for kv in ("", "bfloat16", "int8"):
        for quantize, bits in QUANT:
            for lanes, tok_s, ttft, prompt in ((None, 100.0, None, None),
                                               (7.5, 2500.0, 80.0, 512),
                                               (0.5, 0.0, 12.0, 128)):
                kwargs = dict(p50_ttft_ms=ttft, prompt_len=prompt, draft_model=draft,
                              n_chips=2 if lanes == 0.5 else 1, assumed_lanes=4.0,
                              kv_pool_bytes=3e9 if kv == "int8" else None)
                got = troof.grade(model, "bfloat16", quantize, bits, kv, tok_s, lanes,
                                  300.0, chip=chip, **kwargs)
                want = jroof.grade(model, "bfloat16", quantize, bits, kv, tok_s, lanes,
                                   300.0, chip=_as_reference(chip), **kwargs)
                assert got == want


def test_h100_spec_is_the_datasheet():
    spec = troof.CHIP_SPECS["h100-sxm"]
    assert (spec.peak_bf16_flops, spec.hbm_bytes_per_s, spec.hbm_bytes) == (989e12, 3.35e12, 80e9)


def test_detect_chip_is_none_on_the_cpu():
    assert troof.detect_chip() is None


@pytest.mark.parametrize("name, want", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA A100-SXM4-80GB", None),
    ("Some Future Card", None),
])
def test_detect_chip_maps_only_the_reported_h100_sxm(monkeypatch, name, want):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    spec = troof.detect_chip()
    assert (spec.name if spec is not None else None) == want


def test_detect_chip_is_none_when_the_runtime_raises(monkeypatch):
    import torch

    def boom(*a):
        raise RuntimeError("no driver")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", boom)
    assert troof.detect_chip() is None
