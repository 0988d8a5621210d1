from .deeper_gcn import DeeperGCN, DeeperGCNConfig
from .rev_gcn import RevGCN, RevGCNConfig

__all__ = ["DeeperGCN", "DeeperGCNConfig", "RevGCN", "RevGCNConfig"]
