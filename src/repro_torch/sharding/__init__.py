"""Sharding specs of the port (counterpart of ``repro.sharding``)."""
from . import specs

__all__ = ["specs"]
