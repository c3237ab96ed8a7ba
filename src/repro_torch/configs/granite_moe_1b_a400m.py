"""Config module for --arch granite-moe-1b-a400m (assignment table)."""
from repro_torch.configs.archs import GRANITE_MOE_1B_A400M as CONFIG

CONFIG = CONFIG
