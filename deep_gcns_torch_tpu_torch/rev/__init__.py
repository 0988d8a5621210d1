from .coupling import GroupAdditiveCoupling
from .invertible import reversible_stack
from .rev_layer import GENBlock

__all__ = ["GENBlock", "GroupAdditiveCoupling", "reversible_stack"]
