"""Probes: ports of the JAX package's Pallas probes in `benchmarks/`.

`step_arith` is `benchmarks/pallas_step_arith.py` (B1, B2: a fused play step
with in-kernel draws, per step or per 24-step chunk, analytic or table-fed
heads) and `gather` is the row-gather probes (B3-B6).  Each runs as a module
(`python -m fast_monte_carlo_tpu_torch.probes.step_arith`) on the card by
default; nothing runs at import.
"""
