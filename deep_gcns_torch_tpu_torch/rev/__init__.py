from .coupling import GroupAdditiveCoupling
from .invertible import reversible_stack
from .rev_layer import GATBlock, GCNBlock, GENBlock, SAGEBlock

__all__ = ["GATBlock", "GCNBlock", "GENBlock", "GroupAdditiveCoupling", "SAGEBlock",
           "reversible_stack"]
