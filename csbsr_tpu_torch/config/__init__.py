from .node import CfgNode
from .defaults import get_cfg_defaults

__all__ = ["CfgNode", "get_cfg_defaults"]
