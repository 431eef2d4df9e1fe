"""The port's analysis tier: graphlint (`graph.py`), the counterpart of the
reference's polykey_tpu/analysis/graph.py over the port's CUDA graphs and
eager dispatches, with the parts of the reference's core and baseline it
uses (`core.py`). The reference's four stdlib AST tiers (polylint,
racelint, memlint, schedlint) read the port's sources as they are
(`make port-lint`).

    python -m polykey_tpu_torch.analysis graph [--only GL00x,...] [--json]
        [--write-baseline] [--prune] [--profile smoke|full]

Exit codes: 0 clean, 1 blocking findings, 2 usage. The CLI drives CPU
engines; `graph.GraphEnv(device="cuda")` runs the tier on the card
(chip_smoke.py's phase 18).
"""
