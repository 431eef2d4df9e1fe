"""PyTorch/CUDA port of the polykey serving stack, for NVIDIA Hopper GPUs.

A package of its own beside the JAX reference (``polykey_tpu``): module
names mirror the reference (``models/``, ``ops/``, ``engine/``,
``gateway/``, ``proto/``) so each counterpart is easy to find, but nothing
here imports JAX or the reference package — the jax-free pieces it needs
(model registry, engine config, tokenizer, gateway, generated protos) are
kept as copies.

The serving path runs on the GPU unless the caller asks for the CPU
(``device="cpu"`` or ``POLYKEY_DEVICE=cpu``; see ``device.py``). The
attention kernels the reference wrote in Pallas for the TPU are CUDA C++
kernels for ``sm_90a`` here (``csrc/``), built on first use with ``nvcc``
and bound with ``ctypes`` (``ops/_build.py``).
"""
