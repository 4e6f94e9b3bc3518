"""Benchmark of isac_tpu_torch, the PyTorch/CUDA port, on NVIDIA H100 cards.

One run measures one cell of BENCHMARK.json:

    python3 -m isacbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json`` (whose
``kind`` names a module of ``kinds/``), and each per-layer metric's reader
in ``metrics/<metric>.py``. The plain reference that decides ``correct`` lives
in ``reference/``. Nothing here imports jax or the JAX package.
"""
