from .defaults import get_default_config, update_config
from .io import export_deepspeed_config, save_config
from .names import (
    get_config_name,
    get_lr_scheduler_name,
    get_model_name,
    get_train_name,
)
from .node import CfgNode

__all__ = [
    "CfgNode",
    "get_default_config",
    "update_config",
    "save_config",
    "export_deepspeed_config",
    "get_model_name",
    "get_lr_scheduler_name",
    "get_train_name",
    "get_config_name",
]
