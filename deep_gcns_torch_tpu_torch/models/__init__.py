from .deeper_gcn import DeeperGCN, DeeperGCNConfig
from .deepgcn import (DeepGCNCls, DeepGCNConfig, DeepGCNStatic, DenseDeepGCN,
                      SparseDeepGCN)
from .link_predictor import LinkPredictor
from .rev_gat import RevGAT, RevGATBlock, RevGATConfig
from .rev_gcn import RevGCN, RevGCNConfig

__all__ = ["DeepGCNCls", "DeepGCNConfig", "DeepGCNStatic", "DeeperGCN", "DeeperGCNConfig",
           "DenseDeepGCN", "LinkPredictor", "RevGAT", "RevGATBlock", "RevGATConfig", "RevGCN",
           "RevGCNConfig", "SparseDeepGCN"]
