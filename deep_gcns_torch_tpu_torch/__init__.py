"""PyTorch/CUDA port of the DeeperGCN framework in `deep_gcns_torch_tpu`.

The JAX package is the reference; this package mirrors its layout
(`graph`, `nn/core`, `ops/segment`, `convs/sparse`, `models/deeper_gcn`,
`utils/...`) in PyTorch idiom. The hot-path kernels are hand-written CUDA C++
for Hopper (`csrc/`), each with a plain PyTorch version beside it that serves
tensors on the CPU and is the kernel's oracle on the card.

This package imports torch and numpy only: never jax, never the JAX package.
"""

import torch

from .device import resolve_device

# The first `torch.exp` of a process on the CPU (seen with torch 2.13.0+cpu
# and OpenMP) has computed, in a few fresh processes in a hundred, one worker
# thread's share of a large tensor with wrong values (relative errors near
# 1e-4); every later call agrees bit for bit with every other. The plain
# versions of the kernels, their oracles, must not take that call: one small
# exp on the calling thread takes it here (tests/test_torch_plain_repeat.py).
torch.exp(torch.zeros(8))

__all__ = ["resolve_device"]
