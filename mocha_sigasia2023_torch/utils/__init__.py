"""Config loading (a YAML-subset reader), output directories, seeding,
parameter listings and metrics logging."""

from .config import describe_params, ensure_dirs, get_config, set_seed
