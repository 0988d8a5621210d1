from .core import (MLP, BatchNorm, Embedding, Identity, InstanceNorm, LayerNorm, Linear,
                   MultiEmbedding, PReLU, act_layer, activation, dropout, init_all,
                   kaiming_reinit, make_norm, prelu_init, shared_dropout_mask)

__all__ = ["MLP", "BatchNorm", "Embedding", "Identity", "InstanceNorm", "LayerNorm", "Linear",
           "MultiEmbedding", "PReLU", "act_layer", "activation", "dropout", "init_all",
           "kaiming_reinit", "make_norm", "prelu_init", "shared_dropout_mask"]
