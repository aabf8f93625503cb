from nerficg_torch.core.config import (ConfigNode, Configurable, apply_overrides,
                                       default_global_config, load_config,
                                       recursive_update, save_config)
from nerficg_torch.core.errors import *  # noqa: F401,F403
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.registry import Datasets, Methods, register_dataset, register_method
from nerficg_torch.core.setup import FrameworkContext, setup, teardown
