"""Public model API: one object per architecture config.

Ports ``repro.models.Model`` for the dense, moe, ssm and hybrid families:
the training loss, the train half of the batch declaration, the
full-sequence ``prefill`` and the methods the two serving engines call (the
chunk and paged ones for the attention-cache families, dense and moe, as
in the reference).  The reference's ``use_pallas``
switch has no counterpart: the tensors' device picks the kernel or its
plain version.  A ``Model`` holds no tensors; weights and caches are
passed in, and caches are updated in place, so the decode methods return
only what the reference returns beside its new cache.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import decode as D
from repro_torch.models import params as P
from repro_torch.models import stack
from repro_torch.models.layers import cross_entropy


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---- parameters ----
    def param_specs(self) -> dict:
        return P.param_specs(self.cfg)

    def init_params(self, generator: torch.Generator,
                    device: str | torch.device) -> dict:
        return P.initialize(self.param_specs(), generator, device)

    # ---- training ----
    def loss(self, params: dict, batch: dict, *, remat: str = "none",
             z_loss: float = 0.0) -> tuple[torch.Tensor, dict]:
        logits, metrics = stack.forward(self.cfg, params, batch, remat=remat)
        loss, aux = cross_entropy(logits, batch["labels"],
                                  self.cfg.vocab_size, z_loss)
        metrics.update(aux)
        if "moe_aux" in metrics:
            loss = loss + self.cfg.router_aux_weight * metrics["moe_aux"]
        return loss, metrics

    # ---- batch declaration (train) ----
    def input_specs(self, shape: ShapeConfig) -> dict[str, tuple]:
        """``{name: (shape, dtype)}`` of a training batch: tokens and
        labels for the dense, moe, ssm and hybrid families."""
        if shape.kind != "train":
            raise ValueError(f"the port declares training batches only, got "
                             f"{shape.kind!r}")
        if self.cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise ValueError(f"the port declares the dense, moe, ssm and "
                             f"hybrid batches, got {self.cfg.family!r}")
        tok = ((shape.global_batch, shape.seq_len), torch.int32)
        return {"tokens": tok, "labels": tok}

    def sample_batch(self, shape: ShapeConfig, seed: int,
                     device: str | torch.device) -> dict[str, torch.Tensor]:
        """A random batch matching ``input_specs`` on ``device``: token ids
        uniform over the real vocab, drawn in declaration order from
        numpy's ``default_rng(seed)`` (the reference draws from
        ``jax.random``)."""
        rng = np.random.default_rng(seed)
        return {name: torch.tensor(
                    rng.integers(0, self.cfg.vocab_size, size=dims),
                    dtype=dtype, device=device)
                for name, (dims, dtype) in self.input_specs(shape).items()}

    # ---- serving: prefill and contiguous decode ----
    def prefill(self, params: dict, batch: dict,
                cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """(last-position logits [B, Vpad], a fresh cache for
        ``decode_step``)."""
        return D.prefill(self.cfg, params, batch, cache_len)

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
        return D.decode_step(self.cfg, params, cache, token, pos)

    def decode_greedy_step(self, params: dict, cache: dict,
                           token: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
        """One-token decode with argmax: tokens [B] (the all-greedy path;
        none of the sampling pipeline runs)."""
        return self.decode_step(params, cache, token, pos).argmax(dim=-1)

    def decode_sample_step(self, params: dict, cache: dict,
                           token: torch.Tensor, pos: torch.Tensor,
                           lane: dict) -> torch.Tensor:
        """One-token decode with fused sampling; greedy lanes still get
        exact argmax."""
        return D.sample_from_logits(
            self.decode_step(params, cache, token, pos), lane)

    # ---- serving: gather pathway (dense per-slot cache) ----
    def decode_chunk(self, params: dict, cache: dict, tokens: torch.Tensor,
                     pos: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
        return D.decode_chunk(self.cfg, params, cache, tokens, pos, n_new)

    def decode_greedy_chunk(self, params: dict, cache: dict,
                            tokens: torch.Tensor, pos: torch.Tensor,
                            n_new: torch.Tensor) -> torch.Tensor:
        """Chunked decode with argmax (the gather pathway, all-greedy)."""
        return self.decode_chunk(params, cache, tokens, pos,
                                 n_new).argmax(dim=-1)

    def decode_sample_chunk(self, params: dict, cache: dict,
                            tokens: torch.Tensor, pos: torch.Tensor,
                            n_new: torch.Tensor, lane: dict) -> torch.Tensor:
        """Chunked decode with fused sampling (the gather pathway)."""
        return D.sample_from_logits(
            self.decode_chunk(params, cache, tokens, pos, n_new), lane)

    # ---- serving: paged ----
    def decode_paged_chunk(self, params: dict, cache: dict,
                           tokens: torch.Tensor, pos: torch.Tensor,
                           n_new: torch.Tensor,
                           page_table: torch.Tensor) -> torch.Tensor:
        return D.decode_paged_chunk(self.cfg, params, cache, tokens, pos,
                                    n_new, page_table)

    def decode_paged_greedy_chunk(self, params: dict, cache: dict,
                                  tokens: torch.Tensor, pos: torch.Tensor,
                                  n_new: torch.Tensor,
                                  page_table: torch.Tensor) -> torch.Tensor:
        """Chunked decode over the paged pool with argmax: the paged
        engine's all-greedy step."""
        return self.decode_paged_chunk(params, cache, tokens, pos, n_new,
                                       page_table).argmax(dim=-1)

    def decode_paged_sample_chunk(self, params: dict, cache: dict,
                                  tokens: torch.Tensor, pos: torch.Tensor,
                                  n_new: torch.Tensor,
                                  page_table: torch.Tensor,
                                  lane: dict) -> torch.Tensor:
        """Chunked paged decode with fused sampling."""
        return D.sample_from_logits(
            self.decode_paged_chunk(params, cache, tokens, pos, n_new,
                                    page_table), lane)

    # ---- caches ----
    def cache_specs(self, batch: int, seq_len: int) -> dict:
        return D.cache_specs(self.cfg, batch, seq_len)

    def paged_cache_specs(self, num_blocks: int, block_size: int) -> dict:
        return D.paged_cache_specs(self.cfg, num_blocks, block_size)

    def zero_cache(self, batch: int, seq_len: int,
                   device: str | torch.device) -> dict:
        return P.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            self.cache_specs(batch, seq_len))


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
