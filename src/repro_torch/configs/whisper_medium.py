"""Config module for --arch whisper-medium (assignment table)."""
from repro_torch.configs.archs import WHISPER_MEDIUM as CONFIG

CONFIG = CONFIG
