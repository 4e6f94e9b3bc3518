"""PyTorch + CUDA port of isac_tpu for one NVIDIA H100 (Hopper, sm_90a).

The package mirrors isac_tpu's layout: each module sits at the same relative
path as its JAX counterpart and is held against it by tests/test_torch_*.py.
It imports torch and numpy only — never jax and nothing of isac_tpu — so it
runs on a GPU host without JAX.

Entry points take ``device=None``, which means the card ("cuda"); they raise
when no card is present. The CPU tests pass ``device="cpu"`` explicitly, and
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""
