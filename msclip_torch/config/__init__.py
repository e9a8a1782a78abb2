from .defaults import get_default_config, update_config
from .node import CfgNode

__all__ = ["CfgNode", "get_default_config", "update_config"]
