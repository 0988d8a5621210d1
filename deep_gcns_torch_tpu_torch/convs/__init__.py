from .sparse import GENConv, MsgNorm

__all__ = ["GENConv", "MsgNorm"]
