"""Config loading (a YAML-subset reader) and output directories."""

from .config import ensure_dirs, get_config
