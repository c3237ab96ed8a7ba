"""Config module for --arch deepseek-7b (assignment table)."""
from repro_torch.configs.archs import DEEPSEEK_7B as CONFIG

CONFIG = CONFIG
