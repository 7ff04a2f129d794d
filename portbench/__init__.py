"""The benchmark of heyoka_tpu_torch, the PyTorch and CUDA port, on one
NVIDIA H100 (``run.py``; ``BENCHMARK.json`` at the checkout's root).  It
imports neither JAX nor the JAX package, and ``reference/`` imports
nothing of the program."""
