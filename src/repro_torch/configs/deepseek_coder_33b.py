"""Config module for --arch deepseek-coder-33b (assignment table)."""
from repro_torch.configs.archs import DEEPSEEK_CODER_33B as CONFIG

CONFIG = CONFIG
