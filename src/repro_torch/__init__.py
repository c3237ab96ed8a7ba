"""PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors the JAX package module by module (``repro_torch/models/attention.py``
is the counterpart of ``repro/models/attention.py``, and so on) and imports
nothing of it.  Each TPU kernel of the reference becomes a kernel written by
hand for sm_90a, beside its plain PyTorch version (``kernels/``).
"""
