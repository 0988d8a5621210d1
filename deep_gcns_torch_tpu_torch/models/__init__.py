from .deeper_gcn import DeeperGCN, DeeperGCNConfig

__all__ = ["DeeperGCN", "DeeperGCNConfig"]
