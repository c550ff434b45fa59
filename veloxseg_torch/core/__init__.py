from .config import VeloxSegConfig, load_json_config
from .windows import WindowLayout, compute_window_layout

__all__ = [
    "VeloxSegConfig",
    "load_json_config",
    "WindowLayout",
    "compute_window_layout",
]
