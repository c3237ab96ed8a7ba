"""Config module for --arch mamba2-2.7b (assignment table)."""
from repro_torch.configs.archs import MAMBA2_2P7B as CONFIG

CONFIG = CONFIG
