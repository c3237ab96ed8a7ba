"""Optimizer: AdamW with fp32 master weights, and int8 gradient compression."""
