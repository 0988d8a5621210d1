from .core import (MLP, BatchNorm, InstanceNorm, LayerNorm, Linear, dropout, make_norm,
                   shared_dropout_mask)

__all__ = ["MLP", "BatchNorm", "InstanceNorm", "LayerNorm", "Linear", "dropout",
           "make_norm", "shared_dropout_mask"]
