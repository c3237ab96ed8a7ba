"""Logical-axis → mesh-axis rule tables.

These tables are the single lever the perf pass turns: model code names
logical axes; a rule set binds them to the physical mesh.  ``resolve`` in
ctx.py drops any binding that does not divide the dimension evenly, and
deduplicates mesh axes per tensor (first dimension wins), so e.g. for
``long_500k`` (batch=1) the ``act_batch`` rule drops out and ``act_seq``
picks up the data axes — sequence parallelism falls out of the same table.

Weight logical axes:
  embed      d_model dim of every projection (FSDP axis in training)
  heads_out  flattened n_heads·head_dim output of Q and attn-out input
  kv_out     flattened kv_heads·head_dim
  mlp        d_ff
  vocab      (padded) vocabulary
  experts    expert count (EP)
  ssm_inner  Mamba2 d_inner / conv channels
  ssm_heads  Mamba2 head count
  layers     stacked-scan dim (never sharded)

Activation logical axes: act_batch, act_seq, act_embed, act_heads, act_kv,
act_mlp, act_vocab, act_experts, act_inner; cache axes: cache_batch,
cache_seq, cache_kv.
"""
from __future__ import annotations

from repro_torch.configs.base import RunConfig

Rule = dict[str, tuple[str, ...] | str | None]

_TP = "model"
_DP = ("pod", "data")

# Production training rules: 2D FSDP(pod,data) × TP(model); ZeRO-3 optimizer
# sharding falls out because opt state shares the param specs.
TRAIN: Rule = {
    "embed": _DP,
    "heads_out": _TP, "kv_out": _TP, "mlp": _TP, "vocab": _TP,
    "experts": _TP, "ssm_inner": _TP, "ssm_heads": _TP,
    "layers": None, "groups": None,
    "act_batch": _DP, "act_seq": _DP, "act_embed": None,
    # act_res: the residual stream between blocks (the scan carry that is
    # saved for backward).  Sequence-sharding it over the model axis is
    # Megatron sequence parallelism: GSPMD inserts the all-gather at block
    # entry and the reduce-scatter after the block's row-parallel matmul,
    # and the per-layer saved activations shrink by the TP width.
    "act_res": _TP,
    "act_heads": _TP, "act_kv": _TP, "act_mlp": _TP, "act_vocab": _TP,
    "act_experts": _TP, "act_inner": _TP,
    "cache_batch": _DP, "cache_seq": None, "cache_kv": _TP,
    "cache_seq_tp": _TP,
}

# Pure DP+TP without FSDP — the "as-shipped portable image" the paper's
# container gives you before any host-side tuning.  Kept for the §Perf
# baseline contrast on small models (large models OOM, which memory_analysis
# proves — that is itself a §Perf data point).
TRAIN_NO_FSDP: Rule = dict(TRAIN, embed=None)

# Without sequence-parallel residual sharding (per-layer saved activations
# replicated over the model axis) — §Perf contrast.
TRAIN_NO_SP: Rule = dict(TRAIN, act_res=None)

# Serving: weights TP-only (replicated over data — decode all-gathers of
# FSDP weights every token would dominate); cache sharded batch×heads; for
# batch=1 long-context the cache_seq rule picks up the data axes.
SERVE: Rule = {
    "embed": None,
    "heads_out": _TP, "kv_out": _TP, "mlp": _TP, "vocab": _TP,
    "experts": _TP, "ssm_inner": _TP, "ssm_heads": _TP,
    "layers": None, "groups": None,
    "act_batch": _DP, "act_seq": _DP, "act_embed": None,
    "act_res": None,  # decode activations are tiny; prefill re-adds SP below
    "act_heads": _TP, "act_kv": _TP, "act_mlp": _TP, "act_vocab": _TP,
    "act_experts": _TP, "act_inner": _TP,
    "cache_batch": _DP, "cache_seq": _DP, "cache_kv": _TP,
    "cache_seq_tp": _TP,
}

# Prefill benefits from sequence-parallel residuals like training does.
SERVE_SP: Rule = dict(SERVE, act_res=_TP)

# Prefill for very large models: weights additionally FSDP-sharded over the
# data axes (per-layer gathers amortize over the whole prompt; TP-only
# weights alone would not leave HBM headroom for the 32k activations).
SERVE_SP_FSDP: Rule = dict(SERVE_SP, embed=_DP)

# Serving with weights additionally sharded over data (for models whose
# TP-only weights do not fit); decode then pays per-layer weight gathers.
SERVE_FSDP: Rule = dict(SERVE, embed=_DP)

RULESETS: dict[str, Rule] = {
    "train": TRAIN,
    "train_no_fsdp": TRAIN_NO_FSDP,
    "train_no_sp": TRAIN_NO_SP,
    "serve": SERVE,
    "serve_sp": SERVE_SP,
    "serve_sp_fsdp": SERVE_SP_FSDP,
    "serve_fsdp": SERVE_FSDP,
}

# TP-only weights above this per-device size force FSDP prefill sharding.
_PREFILL_FSDP_BYTES = 3 * 2**30


def rules_for(run: RunConfig) -> Rule:
    name = run.rules
    if name in ("auto", "baseline"):
        if run.shape.is_train:
            name = "train"
        elif run.shape.kind == "prefill":
            tp = run.mesh.axis_size("model")
            w_dev = 2 * run.model.param_count() / max(tp, 1)
            name = ("serve_sp_fsdp" if w_dev > _PREFILL_FSDP_BYTES
                    else "serve_sp")
        else:
            name = "serve"
    return RULESETS[name]
