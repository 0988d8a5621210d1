from .deeper_gcn import DeeperGCN, DeeperGCNConfig
from .link_predictor import LinkPredictor
from .rev_gat import RevGAT, RevGATBlock, RevGATConfig
from .rev_gcn import RevGCN, RevGCNConfig

__all__ = ["DeeperGCN", "DeeperGCNConfig", "LinkPredictor", "RevGAT", "RevGATBlock",
           "RevGATConfig", "RevGCN", "RevGCNConfig"]
