from .core import MLP, BatchNorm, InstanceNorm, LayerNorm, Linear, dropout, make_norm

__all__ = ["MLP", "BatchNorm", "InstanceNorm", "LayerNorm", "Linear", "dropout",
           "make_norm"]
