"""Config loading (a YAML-subset reader), output directories, seeding,
parameter listings, checkpoint listing and metrics logging."""

from .config import (describe_params, ensure_dirs, get_config,
                     get_model_list, set_seed)
