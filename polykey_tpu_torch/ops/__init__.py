"""Attention ops and the hand-written CUDA kernels' wrappers.

Each kernel module holds the kernel's wrapper, its plain PyTorch version
and its `KERNEL` launch counter:

- flash_attention.py       — prefill attention (csrc/flash_attention.cu)
- paged_attention_kernel.py — decode attention (csrc/paged_attention_decode.cu)
- paged_write_kernel.py    — decode KV write (csrc/paged_write.cu)
"""
