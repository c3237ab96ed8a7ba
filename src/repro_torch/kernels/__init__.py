"""Hand-written Hopper kernels (``csrc/``), their builds and wrappers, each
beside its plain PyTorch version."""
