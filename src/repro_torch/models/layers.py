"""Layer primitives on tensors: norms, RoPE, sinusoidal positions, SwiGLU
and GELU MLPs, embeddings, the loss, GQA head geometry and the
sequence-parallel transitions.

Ports ``repro.models.layers``.  The rounding points follow the reference
exactly (fp32 statistics in ``rmsnorm``, fp32 angles in ``rope``, one cast
back at the end of each), which is what keeps reduced-size token streams
identical across the two frameworks on the CPU.

Under a bound rule set whose residual stream is sequence-sharded over
``model`` (``act_res``, the training rules), each rank holds ``[B, S/tp,
D]`` of it (Megatron sequence parallelism) and the helpers below carry the
reference's collective pairs (``parallel.comm``): ``sp_gather_seq`` and
``sp_col_projects`` all-gather the sequence (reduce-scatter backward) in
front of the column-parallel projections, ``rs_project`` reduce-scatters
the row-parallel product back (all-gather backward), ``embed_tokens``
reduce-scatters the vocab-sharded lookup, and ``cross_entropy`` reduces
the vocab-sharded statistics.  With no such context every helper is the
plain product the single-device step takes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import comm
from repro_torch.parallel.ctx import _current


def ceil_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------- norms


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in fp32, cast back to ``x.dtype``, then scale by ``w``."""
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------- rope


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split.  x: [..., seq, heads, head_dim],
    pos: [..., seq]."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = pos[..., :, None].float() * freqs        # [..., seq, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, offset: torch.Tensor | int = 0,
                         device: str | torch.device | None = None
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings, bf16: ``[seq, d]`` for an
    int ``offset``; a ``[B, 1]`` position tensor (a decode step's, with
    ``seq`` 1) gives ``[B, d]``.  Angles in fp32, sines then cosines, as
    the reference."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    pos = torch.arange(seq, device=device)[:, None] + offset
    dim = torch.arange(d // 2, device=device)[None, :]
    inv = torch.exp(-torch.log(torch.tensor(10000.0, device=device)) * dim
                    / max(d // 2 - 1, 1))
    ang = pos.float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)],
                     dim=-1).to(torch.bfloat16)


# ---------------------------------------------------------------- MLP


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with ``sigmoid = 1 / (1 + exp(-x))``, each op
    rounded to ``x.dtype``: the reference's ``jax.nn.silu`` lowers to that
    chain.  ``F.silu`` rounds once and differs in about a third of the bf16
    outputs by one ulp."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    g, u = sp_col_projects(x, (p["gate"], p["up"]), ("act_mlp", "act_mlp"))
    return rs_project(silu(g) * u, p["down"], "act_mlp")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation (``jax.nn.gelu``'s default),
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))``, each op rounded
    to ``x.dtype`` and each constant cast to it first, as the reference's
    chain lowers.  ``F.gelu(approximate="tanh")`` rounds once and differs
    in 44% of the bf16 outputs by one ulp."""
    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = const(0.7978845608028654) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    (u,) = sp_col_projects(x, (p["up"],), ("act_mlp",))
    return rs_project(gelu(u), p["down"], "act_mlp")


# ---------------------------------------------------------------- embed / head


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> [B, S, D].  Sequence-parallel, the table is this
    rank's vocab rows: a token outside them contributes zero, and the sum
    over ``model`` is reduce-scattered over the sequence to the residual
    stream's ``[B, S/tp, D]``.

    The lookup is ``embedding``, whose backward sums a token's rows in
    fp32 before the one rounding to the table's dtype.  Indexing's
    backward on the card adds a bf16 table's rows in bf16, so a frequent
    token's thousands of rows drift, and by a different amount on each
    split of the batch over data ranks."""
    c = _sp_ctx()
    if c is None:
        return F.embedding(tokens, p["tok"])
    ctx, _ = c
    rows = p["tok"].shape[0]
    ids = tokens.long() - ctx.coordinate(("model",)) * rows
    mine = (ids >= 0) & (ids < rows)
    x = F.embedding(ids.clamp(0, rows - 1), p["tok"])
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype))
    return comm.reduce_scatter(x, 1, ctx.group(("model",)))


def logits_from(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits over the whole padded vocab, in fp32 (as the reference:
    argmax runs over the padded ids too).  Sequence-parallel, ``x`` is
    gathered over the sequence and the logits are this rank's vocab
    columns, ``[B, S, V/tp]``."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return (sp_gather_seq(x) @ w).float()


# ---------------------------------------------------------------- loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, z_loss: float = 0.0
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean next-token CE over all positions, in fp32; the padded vocab ids
    are masked out, and ``z_loss`` adds ``z_loss * mean(lse**2)``.

    Under a bound mesh the logits are this rank's rows of the batch (and
    its vocab columns, sequence-parallel): the statistics are reduced over
    ``model`` (``_VocabParallel``) and the means are over the global batch
    (``global_mean``)."""
    c = _sp_ctx()
    if c is None:
        v_pad = logits.shape[-1]
        if v_pad > vocab_size:
            pad = torch.arange(v_pad, device=logits.device) >= vocab_size
            logits = logits.masked_fill(pad, -1e9)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        ctx, _ = c
        offset = ctx.coordinate(("model",)) * logits.shape[-1]
        lse, gold = _VocabParallel.apply(logits, labels, vocab_size, offset,
                                         ctx.group(("model",)))
    loss = global_mean(lse - gold)
    aux = {"nll": loss}
    if z_loss:
        zl = z_loss * global_mean(lse ** 2)
        aux["z_loss"] = zl
        loss = loss + zl
    return loss, aux


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over every rank's rows: ``t.mean()`` with no mesh
    bound; a sum over the data axes otherwise (each rank holds
    ``1 / dp`` of the batch, and ``model`` ranks hold the same rows), its
    backward the identity (every rank's loss is the whole loss)."""
    ctx = _current()
    if ctx is None:
        return t.mean()
    dp = [a for a in ctx.mesh.mesh_dim_names if a != "model"]
    total = comm.all_reduce(t.sum(), ctx.group(dp))
    return total / (t.numel() * ctx.size(dp))


class _VocabParallel(torch.autograd.Function):
    """Per-row log-sum-exp and gold logit of vocab-sharded fp32 logits
    ``[..., V/tp]`` (this rank's columns start at ``offset``): the max and
    the sum of exponentials are reduced over ``model``, and the gold logit
    summed from the one rank that holds it, rather than gathering the
    logits.  Padded columns are masked as at tp=1.  Every ``model`` rank
    gets the whole per-row result, and its cotangents are the whole ones,
    so the backward is local: ``softmax * dlse``, plus ``dgold`` at the gold
    column where this rank holds it."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_size, offset, group):
        cols = offset + torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(cols >= vocab_size, -1e9)
        m = logits.amax(dim=-1)
        comm.dist.all_reduce(m, op=comm.dist.ReduceOp.MAX, group=group)
        sumexp = comm.sum_all(torch.exp(logits - m[..., None]).sum(dim=-1),
                              group)
        lse = m + torch.log(sumexp)
        local = labels.long() - offset
        mine = (local >= 0) & (local < logits.shape[-1])
        gold = torch.gather(logits, -1,
                            local.clamp(0, logits.shape[-1] - 1)[..., None])
        gold = comm.sum_all(torch.where(mine, gold[..., 0], 0.0), group)
        ctx.save_for_backward(logits, lse, local, mine)
        return lse, gold

    @staticmethod
    def backward(ctx, dlse, dgold):
        logits, lse, local, mine = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None]) * dlse[..., None]
        grad.scatter_add_(-1, local.clamp(0, logits.shape[-1] - 1)[..., None],
                          torch.where(mine, dgold, 0.0)[..., None])
        return grad, None, None, None, None


# ---------------------------------------------------------------- GQA geometry


@dataclasses.dataclass(frozen=True)
class HeadGeom:
    """Padding geometry making GQA shardable over a ``tp``-wide model axis.

    train/prefill compute: kv replicated over tp; q padded on the group dim
      to ``g_pad`` so that ``kv·g_pad % tp == 0``  (H_run = kv·g_pad).
    decode cache: kv zero-padded to ``kv_pad = ceil_mult(kv, tp)`` so the
      cache head dim itself shards     (H_dec = kv_pad·g).

    The port's training step runs ``h_run / tp`` q heads a rank; its decode
    paths run at tp=1.
    """

    n_heads: int
    n_kv: int
    head_dim: int
    tp: int

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv

    @property
    def g_pad(self) -> int:
        g = self.group
        while (self.n_kv * g) % self.tp:
            g += 1
        return g

    @property
    def h_run(self) -> int:
        return self.n_kv * self.g_pad

    @property
    def kv_pad(self) -> int:
        return ceil_mult(self.n_kv, self.tp)

    @property
    def h_dec(self) -> int:
        return self.kv_pad * self.group


def head_geom(cfg: ModelConfig, tp: int = 1) -> HeadGeom:
    return HeadGeom(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp)


def pad_group_dim(w: torch.Tensor, geom: HeadGeom,
                  axis_is_out: bool) -> torch.Tensor:
    """Zero-pad a [*, H·hd] (or [H·hd, *]) projection to the padded run
    layout [*, kv·g_pad·hd] keeping q heads grouped by their kv head."""
    if geom.g_pad == geom.group:
        return w
    hd, kv, g, gp = geom.head_dim, geom.n_kv, geom.group, geom.g_pad
    if axis_is_out:
        d = w.shape[0]
        w4 = torch.nn.functional.pad(w.reshape(d, kv, g, hd),
                                     (0, 0, 0, gp - g))
        return w4.reshape(d, kv * gp * hd)
    d = w.shape[1]
    w4 = torch.nn.functional.pad(w.reshape(kv, g, hd, d),
                                 (0, 0, 0, 0, 0, gp - g))
    return w4.reshape(kv * gp * hd, d)


# ------------------------------------------------ explicit SP transitions
#
# Megatron sequence parallelism needs exactly two collectives per block
# half: all-gather(seq) at entry, reduce-scatter(seq) after the
# row-parallel projection.  The reference writes them in shard_map bodies
# so that they travel in bf16; here they are ``parallel.comm``'s autograd
# functions, whose payload is the tensor's own dtype.  Each helper is the
# plain product when ``_sp_ctx`` finds no sequence sharding.


def _sp_ctx():
    """``(ctx, tp)`` when the bound rules sequence-shard the residual
    stream over a ``model`` axis wider than one, else ``None``.  The step
    checks once, at ``stack.forward``, that the sequence and the batch
    split evenly, so the helpers need no shapes."""
    ctx = _current()
    if ctx is None:
        return None
    tp = ctx.axis_sizes.get("model", 1)
    if tp <= 1 or ctx.rules.get("act_res") != "model":
        return None
    return ctx, tp


def sp_gather_seq(x: torch.Tensor) -> torch.Tensor:
    """[B, S/tp, D] -> [B, S, D] replicated over model (all-gather;
    reduce-scatter backward)."""
    c = _sp_ctx()
    if c is None:
        return x
    ctx, _ = c
    return comm.all_gather(x, 1, ctx.group(("model",)))


def sp_col_projects(x: torch.Tensor, ws: tuple, features: tuple
                    ) -> tuple[torch.Tensor, ...]:
    """Fused SP entry and column-parallel projections: one all-gather of
    x [B, S/tp, D] serves every ``w`` [D, F_i] (this rank's columns where
    ``features[i]`` names a sharded axis, whole columns where it is
    ``None``), and the backward reduce-scatters the summed dx once."""
    c = _sp_ctx()
    if c is None:
        return tuple(x @ w for w in ws)
    xf = sp_gather_seq(x)
    return tuple(xf @ w for w in ws)


def rs_project(h: torch.Tensor, w: torch.Tensor, feature: str
               ) -> torch.Tensor:
    """Row-parallel projection with fused reduce-scatter: h [B, S, F/tp]
    (``feature`` sharded over model), w [F/tp, D] -> [B, S/tp, D]
    (all-gather backward)."""
    c = _sp_ctx()
    if c is None:
        return h @ w
    ctx, _ = c
    return comm.reduce_scatter(h @ w, 1, ctx.group(("model",)))
