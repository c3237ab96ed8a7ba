"""Public model API: one object per architecture config.

Ports the serving subset of ``repro.models.Model`` for the dense family:
the methods the two engines call.  Training (``loss``) and full-sequence
``prefill`` belong to later slices of the port.  A ``Model`` holds no
tensors; weights and caches are passed in, and caches are updated in
place, so the decode methods return only what the reference returns
beside its new cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D
from repro_torch.models import params as P


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ---- parameters ----
    def param_specs(self) -> dict:
        return P.param_specs(self.cfg)

    def init_params(self, generator: torch.Generator,
                    device: str | torch.device) -> dict:
        return P.initialize(self.param_specs(), generator, device)

    # ---- serving: contiguous (oracle) ----
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
