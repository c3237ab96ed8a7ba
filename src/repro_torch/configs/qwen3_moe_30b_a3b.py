"""Config module for --arch qwen3-moe-30b-a3b (assignment table)."""
from repro_torch.configs.archs import QWEN3_MOE_30B_A3B as CONFIG

CONFIG = CONFIG
