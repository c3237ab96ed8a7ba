"""Config module for --arch phi3-mini-3.8b (assignment table)."""
from repro_torch.configs.archs import PHI3_MINI_3P8B as CONFIG

CONFIG = CONFIG
