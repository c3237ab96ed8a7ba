"""Config module for --arch phi3-medium-14b (assignment table)."""
from repro_torch.configs.archs import PHI3_MEDIUM_14B as CONFIG

CONFIG = CONFIG
