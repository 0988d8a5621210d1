from .dgl_gat import SymGATConv
from .sparse import GENConv, MsgNorm

__all__ = ["GENConv", "MsgNorm", "SymGATConv"]
