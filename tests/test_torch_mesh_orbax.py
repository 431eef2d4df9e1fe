"""An orbax checkpoint (the JAX package's `save_checkpoint`) served by the
port's mesh engine over a 2-rank gloo tp mesh (tests/torch_ranks.py's
`engine` job; each rank reads its shard of the checkpoint through
models/orbax.py): the leader's greedy streams equal the JAX engine's on
the same directory, and the follower replays every dispatch without an
error. The ranks' trees against `shard_params` are held in
tests/test_torch_orbax.py."""

import jax
import jax.numpy as jnp
import numpy as np

import torch_ranks
from polykey_tpu.engine.config import EngineConfig as JEngineConfig
from polykey_tpu.engine.engine import GenRequest as JGenRequest
from polykey_tpu.engine.engine import InferenceEngine as JInferenceEngine
from polykey_tpu.models import loader as jl
from polykey_tpu.models import transformer as jt
from polykey_tpu.models.config import get_config as j_get_config
from polykey_tpu_torch.models.config import get_config

FIELDS = dict(model="tiny-llama", tokenizer="byte", dtype="float32", max_decode_slots=4,
              page_size=8, num_pages=64, max_seq_len=64, prefill_buckets=(16, 32),
              max_new_tokens_cap=32, default_max_new_tokens=8)
PROMPTS = ["hello orbax mesh", "sharded read", "a", "the quick brown fox"]
MAX_NEW = 8


def _jax_streams(path: str) -> list:
    engine = JInferenceEngine(JEngineConfig(**FIELDS, checkpoint_path=path,
                                            compile_warmup=False, supervise=False,
                                            signals_interval_s=0))
    try:
        reqs = [JGenRequest(prompt=p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        for r in reqs:
            engine.submit(r)
        out = []
        for r in reqs:
            toks = []
            while True:
                kind, value = r.out.get(timeout=120)
                assert kind != "error", value
                if kind == "done":
                    break
                toks.append(value)
            out.append(toks)
        return out
    finally:
        engine.shutdown()


def test_a_tp2_mesh_serves_the_jax_engines_streams_from_orbax(tmp_path):
    path = str(tmp_path / "ckpt")
    jl.save_checkpoint(path, jt.init_params(jax.random.PRNGKey(0), j_get_config("tiny-llama"),
                                            jnp.float32))
    job = {"kind": "engine", "name": "orbax-tp2", "devices": [0, 1],
           "config": dict(FIELDS, tp=2, checkpoint_path=path),
           "model": torch_ranks.config_fields(get_config("tiny-llama")), "params": "",
           "prompts": PROMPTS, "max_new": MAX_NEW}
    results = torch_ranks.run(2, [job], tmp_path / "ranks", timeout=240)
    want = _jax_streams(path)
    leader = results[0]
    assert str(leader["orbax-tp2/role"]) == "leader"
    assert list(leader["orbax-tp2/errors"]) == [""] * len(PROMPTS)
    got = [[int(t) for t in row if t >= 0] for row in leader["orbax-tp2/tokens"]]
    assert got == want
    follower = results[1]
    assert str(follower["orbax-tp2/role"]) == "follower"
    assert str(follower["orbax-tp2/error"]) == ""
    assert str(follower["orbax-tp2/digest"]) == str(leader["orbax-tp2/digest"])
    assert np.asarray(leader["orbax-tp2/blocks"]) > 0
