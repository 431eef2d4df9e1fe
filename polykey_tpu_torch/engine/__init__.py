"""Serving engine: config, paged KV cache, sampling, continuous batching."""
