"""Config module for --arch llama-3.2-vision-11b (assignment table)."""
from repro_torch.configs.archs import LLAMA32_VISION_11B as CONFIG

CONFIG = CONFIG
