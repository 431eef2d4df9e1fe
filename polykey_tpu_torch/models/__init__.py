"""Model configs, layers and the paged-KV transformer forward."""
