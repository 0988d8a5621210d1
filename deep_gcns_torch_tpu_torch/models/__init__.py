from .deeper_gcn import DeeperGCN, DeeperGCNConfig
from .rev_gat import RevGAT, RevGATBlock, RevGATConfig
from .rev_gcn import RevGCN, RevGCNConfig

__all__ = ["DeeperGCN", "DeeperGCNConfig", "RevGAT", "RevGATBlock", "RevGATConfig", "RevGCN",
           "RevGCNConfig"]
