"""Link predictor head for ogbl-collab (counterpart of
`deep_gcns_torch_tpu/models/link_predictor.py:19-64`, reference
`examples/ogb/ogbl_collab/model.py:164-203`): score(i, j) =
sigmoid(MLP(x_i ⊙ x_j)), the MLP a stack of Linear → [norm] → ReLU →
dropout and a bare final Linear, under the reference's names `lins.{i}` and
`norms.{i}`."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.core import Linear, dropout, make_norm


class LinkPredictor(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int = 1, num_layers: int = 3,
                 norm: Optional[str] = None, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.dropout = dropout
        self.lins = nn.ModuleList(Linear(dims[i], dims[i + 1], generator=generator)
                                  for i in range(len(dims) - 1))
        has_norm = norm is not None and str(norm).lower() != "none"
        self.norms = nn.ModuleList(make_norm(norm, hidden_dim)
                                   for _ in range(len(dims) - 2)) if has_norm else None

    def forward(self, x_i: torch.Tensor, x_j: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Scores in (0, 1), [E, out_dim]; dropout masks come from
        ``generator`` in training mode."""
        x = x_i * x_j
        for i, lin in enumerate(self.lins[:-1]):
            x = lin(x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = dropout(torch.relu(x), self.dropout, train=self.training, generator=generator)
        return torch.sigmoid(self.lins[-1](x))
