from .dense import (BasicConv, DenseDynBlock2d, DynConv2d, EdgeConv2d, GraphConv2d, MRConv2d,
                    PlainDynBlock2d, ResDynBlock2d, graph_conv2d)
from .dgl_gat import SymGATConv
from .sparse import (DenseDynBlock, DenseGraphBlock, DynConv, EdgeConv, GATConv, GCNConv, GENConv,
                     GINConv, GraphConv, MRConv, MsgNorm, PlainDynBlock, ResDynBlock,
                     ResGraphBlock, RSAGEConv, SemiGCNConv, graph_conv)

__all__ = ["BasicConv", "DenseDynBlock", "DenseDynBlock2d", "DenseGraphBlock", "DynConv",
           "DynConv2d", "EdgeConv", "EdgeConv2d", "GATConv", "GCNConv", "GENConv", "GINConv",
           "GraphConv", "GraphConv2d", "MRConv", "MRConv2d", "MsgNorm", "PlainDynBlock",
           "PlainDynBlock2d", "RSAGEConv", "ResDynBlock", "ResDynBlock2d", "ResGraphBlock",
           "SemiGCNConv", "SymGATConv", "graph_conv", "graph_conv2d"]
