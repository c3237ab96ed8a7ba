"""Parameter specification trees for the dense, moe, ssm and hybrid
families.

Mirrors ``repro.models.params`` together with the reference's spec
constructors for these families (``stack.param_specs``,
``attention.attn_specs``, ``layers.swiglu_specs``/``embed_specs``,
``moe.moe_specs``, ``ssm.ssm_specs``): one
declaration of every parameter's shape, dtype, logical axes and
initializer.  Layer weights are stacked ``[L, ...]`` exactly as in the
reference, so a parameter tree here and the reference's
``Model.init_params`` pytree have the same keys and shapes.

From the declaration:

  * ``initialize(specs, generator, device)`` materialises weights with the
    reference's scales from a seeded ``torch.Generator`` (the bits differ
    from ``jax.random``'s: use ``from_jax`` where bits must agree);
  * ``from_jax(tree)`` is the weight bridge: the reference's numpy'd
    pytree becomes the port's tensors, bit-exact;
  * ``count(specs)`` is the analytic parameter count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]               # logical axis name or None per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                # normal | zeros | ones | embed
    fan_in_axes: tuple[int, ...] = ()   # dims treated as fan-in for scaling

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Map over the leaves of a nested dict (specs, tensors or arrays)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree: Any) -> list[Any]:
    """Leaves in sorted-key order (the order ``jax.tree.flatten`` uses)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def count(specs: Any) -> int:
    return sum(int(np.prod(s.shape)) for s in leaves(specs))


# ---- initialisation --------------------------------------------------------

# A leaf with more elements than this is drawn in slices along its leading
# axis, each at most this size where one leading row allows, so the fp32
# draw beside the weights stays one slice (qwen3-moe's expert leaf
# [48, 128, 2048, 768] would need 38.7 GB at once).
SLICE_ELEMS = 1 << 26


def _init_one(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "embed":
        scale = spec.shape[-1] ** -0.5  # keeps tied-head logits O(1)
    else:
        fan_axes = spec.fan_in_axes or tuple(
            i for i in range(len(spec.shape) - 1)
            if spec.axes[i] not in ("layers", "groups"))
        fan_in = max(int(np.prod([spec.shape[i] for i in fan_axes])), 1)
        scale = fan_in ** -0.5
    n = int(np.prod(spec.shape))
    if n <= SLICE_ELEMS or len(spec.shape) < 2 or spec.shape[0] < 2:
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(spec.dtype)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    step = max(1, SLICE_ELEMS // (n // spec.shape[0]))  # leading rows a draw
    for i in range(0, spec.shape[0], step):
        w = torch.randn((min(step, spec.shape[0] - i),) + spec.shape[1:],
                        generator=generator, dtype=torch.float32,
                        device=device)
        out[i:i + step] = w.mul_(scale)
        del w
    return out


def initialize(specs: Any, generator: torch.Generator,
               device: str | torch.device) -> Any:
    """Materialise a spec tree on ``device``; ``generator`` must live on
    the same device.  Leaves draw in sorted-key order, so one seed gives
    one set of weights on a given device type."""
    device = torch.device(device)
    return tree_map(lambda s: _init_one(s, generator, device), specs)


# ---- the weight bridge -------------------------------------------------------


def _tensor_of(arr: Any) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: JAX hands back ml_dtypes'
        # read-only bfloat16 arrays, which torch.from_numpy rejects.  The
        # 16 bits are reinterpreted, never converted, so the bridge is exact.
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_jax(tree: Any, device: str | torch.device = "cpu") -> Any:
    """The reference's parameter pytree (numpy or JAX arrays in nested
    dicts) as the port's tensors on ``device``, bit for bit."""
    return tree_map(lambda a: _tensor_of(a).to(device), tree)


# ---- spec constructors -------------------------------------------------------


def dense(d_in: int, d_out: int, in_axis: str | None, out_axis: str | None,
          layers: int | None = None,
          dtype: torch.dtype = torch.bfloat16) -> ParamSpec:
    """[L?, d_in, d_out] projection."""
    shape: tuple[int, ...] = (d_in, d_out)
    axes: tuple[Any, ...] = (in_axis, out_axis)
    if layers is not None:
        shape = (layers,) + shape
        axes = ("layers",) + axes
    return ParamSpec(shape, axes, dtype)


def scale(d: int, layers: int | None = None, init: str = "ones") -> ParamSpec:
    shape: tuple[int, ...] = (d,)
    axes: tuple[Any, ...] = (None,)
    if layers is not None:
        shape = (layers,) + shape
        axes = ("layers",) + axes
    return ParamSpec(shape, axes, torch.bfloat16, init=init)


def attn_specs(cfg: ModelConfig, layers: int | None) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    specs = {
        "wq": dense(d, h * hd, "embed", "heads_out", layers),
        "wk": dense(d, kv * hd, "embed", "kv_out", layers),
        "wv": dense(d, kv * hd, "embed", "kv_out", layers),
        "wo": dense(h * hd, d, "heads_out", "embed", layers),
    }
    if cfg.qk_norm:
        specs["q_scale"] = scale(hd, layers)
        specs["k_scale"] = scale(hd, layers)
    return specs


def swiglu_specs(cfg: ModelConfig, layers: int | None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "gate": dense(d, f, "embed", "mlp", layers),
        "up": dense(d, f, "embed", "mlp", layers),
        "down": dense(f, d, "mlp", "embed", layers),
    }


def embed_specs(cfg: ModelConfig) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    specs = {"tok": ParamSpec((v, d), ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        specs["head"] = dense(d, v, "embed", "vocab")
    return specs


def _dense_layer_specs(cfg: ModelConfig, n: int) -> dict:
    return {
        "ln1": scale(cfg.d_model, n),
        "attn": attn_specs(cfg, n),
        "ln2": scale(cfg.d_model, n),
        "mlp": swiglu_specs(cfg, n),
    }


def _moe_layer_specs(cfg: ModelConfig, n: int) -> dict:
    from repro_torch.models.moe import moe_specs  # local: moe imports this
    return {
        "ln1": scale(cfg.d_model, n),
        "attn": attn_specs(cfg, n),
        "ln2": scale(cfg.d_model, n),
        "moe": moe_specs(cfg, n),
    }


def _ssm_layer_specs(cfg: ModelConfig, n: int) -> dict:
    from repro_torch.models.ssm import ssm_specs  # local: ssm imports this
    return {"ln": scale(cfg.d_model, n), "mamba": ssm_specs(cfg, n)}


def _shared_attn_specs(cfg: ModelConfig) -> dict:
    """zamba2's globally shared attention + MLP block (unstacked)."""
    return {
        "attn": attn_specs(cfg, None),
        "mlp": swiglu_specs(cfg, None),
        "ln_attn": scale(cfg.d_model),
        "ln_mlp": scale(cfg.d_model),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The tree of the families the port builds: embed, final norm and the
    stacked layers; ``hybrid`` adds the shared attention block and one
    site norm per group.  vlm and encdec are later slices."""
    specs: dict[str, Any] = {"embed": embed_specs(cfg),
                             "final_norm": scale(cfg.d_model)}
    if cfg.family == "dense":
        specs["layers"] = _dense_layer_specs(cfg, cfg.n_layers)
    elif cfg.family == "moe":
        specs["layers"] = _moe_layer_specs(cfg, cfg.n_layers)
    elif cfg.family == "ssm":
        specs["layers"] = _ssm_layer_specs(cfg, cfg.n_layers)
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        specs["layers"] = _ssm_layer_specs(cfg, groups * (cfg.attn_every - 1))
        specs["shared"] = _shared_attn_specs(cfg)
        specs["site_norm"] = scale(cfg.d_model, groups)
    else:
        raise ValueError(f"the port builds the dense, moe, ssm and hybrid "
                         f"families, got {cfg.family!r} ({cfg.name})")
    return specs
