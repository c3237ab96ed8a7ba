"""Config module for --arch zamba2-2.7b (assignment table)."""
from repro_torch.configs.archs import ZAMBA2_2P7B as CONFIG

CONFIG = CONFIG
