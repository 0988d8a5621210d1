"""PyTorch/CUDA port of the DeeperGCN framework in `deep_gcns_torch_tpu`.

The JAX package is the reference; this package mirrors its layout
(`graph`, `nn/core`, `ops/segment`, `convs/sparse`, `models/deeper_gcn`,
`utils/...`) in PyTorch idiom. The hot-path kernels are hand-written CUDA C++
for Hopper (`csrc/`), each with a plain PyTorch version beside it that serves
tensors on the CPU and is the kernel's oracle on the card.

This package imports torch and numpy only: never jax, never the JAX package.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
