from .dgl_gat import SymGATConv
from .sparse import (DenseGraphBlock, DynConv, EdgeConv, GATConv, GCNConv, GENConv, GINConv,
                     GraphConv, MRConv, MsgNorm, ResGraphBlock, RSAGEConv, SemiGCNConv,
                     graph_conv)

__all__ = ["DenseGraphBlock", "DynConv", "EdgeConv", "GATConv", "GCNConv", "GENConv",
           "GINConv", "GraphConv", "MRConv", "MsgNorm", "RSAGEConv", "ResGraphBlock",
           "SemiGCNConv", "SymGATConv", "graph_conv"]
