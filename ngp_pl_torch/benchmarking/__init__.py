"""Benchmarks of the port's kernels (counterparts of benchmarking/ in the
repository root): `micro_fwd`, the encode-forward ablation bench (K9)."""
