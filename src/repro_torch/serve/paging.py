"""Paged KV cache: block allocator, prefix cache, device page pool, host tier.

The port's counterpart of ``repro.serve.paging``.  The host-side classes
are copies of the reference's (pure Python): ``BlockAllocator``,
``PrefixCache``, ``HostSwapPool``, ``chain_hashes`` and ``pages_for``.
``DevicePageView`` is rewritten on torch tensors.  The reference's
``KVPool`` serves only the ``kernel="gather"`` pathway, which the port
does not have yet.

- ``BlockAllocator`` hands out fixed-size logical pages from a free list
  and refcounts them so pages can be *shared* between requests (and with
  the prefix cache) without copies.  Double-free and unknown-block frees
  raise — the allocator is the invariant-bearing layer the property tests
  hammer.
- ``PrefixCache`` maps hash-chained token blocks to pages holding their
  KV, so requests with a shared prompt prefix reuse the pages instead of
  recomputing prefill.  Registered pages are immutable; readers hold a
  refcount (copy-on-write at page granularity: writers always write into
  freshly allocated pages).
- ``DevicePageView`` is the page pool as device tensors plus per-slot
  page tables, consumed directly by the paged-attention kernel — KV is
  written and attended through the table, prefix sharing is pure
  metadata, and no dense per-slot working cache exists.
- ``HostSwapPool`` is the host swap tier below the device pool:
  preempted requests swap their written pages out instead of discarding
  them (readmission swaps them back in, no re-prefill), and cold prefix
  pages evicted under pressure spill here so ``PrefixCache.match`` can
  page them back in.

Paging governs *admission* (prefix reuse), *capacity* (page accounting +
preemption-on-OOM), *sharing* (refcounts), and *residency* (device vs
host tier).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch


class BlockAllocatorError(RuntimeError):
    """Raised on allocator misuse (double free, unknown block, OOM)."""


@dataclass
class BlockStats:
    allocs: int = 0
    frees: int = 0
    peak_in_use: int = 0
    oom_events: int = 0


class BlockAllocator:
    """Fixed-size page allocator with refcounted sharing.

    Blocks are integers in ``[0, num_blocks)``.  ``alloc`` returns a block
    with refcount 1; ``incref`` adds a reader; ``decref`` releases one
    reference and returns the block to the free list when the count hits
    zero.  All misuse raises ``BlockAllocatorError``.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError((num_blocks, block_size))
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently freed pages are reused first (warm rows)
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: dict[int, int] = {}
        self.stats = BlockStats()

    # ------------------------------------------------------------ queries
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    # ------------------------------------------------------------ lifecycle
    def alloc(self) -> int:
        if not self._free:
            self.stats.oom_events += 1
            raise BlockAllocatorError("out of pages")
        bid = self._free.pop()
        self._ref[bid] = 1
        self.stats.allocs += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        return bid

    def incref(self, bid: int) -> None:
        if bid not in self._ref:
            raise BlockAllocatorError(f"incref on unallocated block {bid}")
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        ref = self._ref.get(bid)
        if ref is None:
            raise BlockAllocatorError(f"free of unallocated block {bid}")
        if ref <= 0:  # pragma: no cover - guarded by deletion below
            raise BlockAllocatorError(f"double free of block {bid}")
        self._ref[bid] = ref - 1
        if self._ref[bid] == 0:
            del self._ref[bid]
            self._free.append(bid)
            self.stats.frees += 1

    def check(self) -> None:
        """Invariant audit: every block is either free or refcounted ≥ 1."""
        assert len(self._free) + len(self._ref) == self.num_blocks
        assert all(r >= 1 for r in self._ref.values())
        assert len(set(self._free)) == len(self._free)
        assert not (set(self._free) & set(self._ref))


# ================================================================= hashing


def chain_hashes(tokens: Sequence[int], block_size: int) -> list[int]:
    """Hash chain over full token blocks: ``h_i = H(h_{i-1}, block_i)``.

    Only complete blocks participate (partial tails are never cached), so
    two prompts share cache entries exactly up to their common full-block
    prefix.  blake2b/8-byte digests keep collisions negligible at serving
    scale while staying deterministic across processes.
    """
    out: list[int] = []
    prev = 0
    for start in range(0, (len(tokens) // block_size) * block_size,
                       block_size):
        block = tokens[start:start + block_size]
        h = hashlib.blake2b(
            np.asarray([prev, *block], dtype=np.uint64).tobytes(),
            digest_size=8)
        prev = int.from_bytes(h.digest(), "little")
        out.append(prev)
    return out


@dataclass
class PrefixStats:
    lookups: int = 0
    hit_blocks: int = 0
    miss_blocks: int = 0
    insertions: int = 0
    evictions: int = 0
    hit_tokens: int = 0
    spills: int = 0      # cold pages copied to the host tier at eviction
    restores: int = 0    # spilled pages paged back in on a match

    @property
    def hit_rate(self) -> float:
        total = self.hit_blocks + self.miss_blocks
        return self.hit_blocks / total if total else 0.0


class PrefixCache:
    """Content-addressed map from token-block hash chains to pages.

    The cache holds one reference on every registered page (so pages
    survive their writer's completion); ``match`` adds one reference per
    matched page on behalf of the caller.  Pages whose only reference is
    the cache's own are *evictable* — ``evict`` reclaims them LRU-first
    under allocator pressure.
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self._map: OrderedDict[int, int] = OrderedDict()  # chain hash -> bid
        self.stats = PrefixStats()
        # cold-page spill tier (armed via attach_spill): hash -> host id,
        # LRU order.  Spilled pages hold host storage only — no device page.
        self._spilled: OrderedDict[int, int] = OrderedDict()
        self._spill_cap = 0
        self._spill_out = None   # bid -> host id | None
        self._page_in = None     # host id -> device bid | None
        self._drop = None        # host id -> None

    def __len__(self) -> int:
        return len(self._map)

    @property
    def spilled(self) -> int:
        """Spilled (host-resident) page count."""
        return len(self._spilled)

    def attach_spill(self, *, spill_out, page_in, drop,
                     capacity: int) -> None:
        """Arm the cold-page spill tier.

        ``spill_out(bid)`` copies a device page's rows to host storage and
        returns a host id (None = tier full, the page is simply dropped);
        ``page_in(host_id)`` allocates a device page, copies the rows back
        and returns the new bid with one reference — the cache's own —
        (None = no device page free, the match stops there); ``drop``
        releases host storage.  ``capacity`` bounds the spilled set,
        oldest entries dropped first.
        """
        self._spill_out, self._page_in, self._drop = spill_out, page_in, drop
        self._spill_cap = capacity

    # ------------------------------------------------------------- lookup
    def match(self, tokens: Sequence[int], *,
              max_tokens: int | None = None) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens``: ``(n_tokens, block_ids)``.

        Caller owns one reference per returned block (release via
        ``allocator.decref``).  ``max_tokens`` caps the match so callers
        can keep at least one token to feed through the model.
        """
        bs = self.allocator.block_size
        self.stats.lookups += 1
        bids: list[int] = []
        for h in chain_hashes(tokens, bs):
            if max_tokens is not None and (len(bids) + 1) * bs > max_tokens:
                break
            bid = self._map.get(h)
            if bid is None:
                bid = self._restore(h)
            if bid is None:
                self.stats.miss_blocks += 1
                break
            self._map.move_to_end(h)  # LRU touch
            self.allocator.incref(bid)
            bids.append(bid)
            self.stats.hit_blocks += 1
        self.stats.hit_tokens += len(bids) * bs
        return len(bids) * bs, bids

    def peek(self, tokens: Sequence[int], *,
             max_tokens: int | None = None) -> int:
        """Matched-token count without taking references (for cost models)."""
        bs = self.allocator.block_size
        n = 0
        for h in chain_hashes(tokens, bs):
            if max_tokens is not None and n + bs > max_tokens:
                break
            if h not in self._map:
                break
            n += bs
        return n

    def _restore(self, h: int) -> int | None:
        """Page a spilled entry back onto the device (None if impossible).

        The restore consumes one free device page; the caller's admission
        arithmetic stays consistent because the restored page joins the
        match's shared list, reducing ``need`` by exactly the page the
        restore consumed.  A failed page-in (device OOM) leaves the entry
        spilled — the match simply stops at the resident prefix.
        """
        hid = self._spilled.get(h)
        if hid is None or self._page_in is None:
            return None
        bid = self._page_in(hid)
        if bid is None:
            return None
        del self._spilled[h]
        self._drop(hid)           # the device copy is authoritative again
        self._map[h] = bid        # page_in's reference becomes the cache's
        self.stats.restores += 1
        return bid

    def chains(self) -> tuple[int, ...]:
        """The resident chain hashes, LRU order (coldest first).  This is
        the cluster router's per-replica summary feed: a replica whose
        cache holds a request's leading chain hashes can serve its prefix
        from pages instead of recomputing it."""
        return tuple(self._map)

    # ----------------------------------------------------------- register
    def contains(self, chain_hash: int) -> bool:
        return chain_hash in self._map

    def insert(self, chain_hash: int, bid: int) -> bool:
        """Register a page under its chain hash.  The cache takes its own
        reference.  Returns False (no ref taken) if the hash is already
        registered — first writer wins, the loser keeps its private page."""
        if chain_hash in self._map:
            return False
        stale = self._spilled.pop(chain_hash, None)
        if stale is not None:     # fresh device copy supersedes the spill
            self._drop(stale)
        self.allocator.incref(bid)
        self._map[chain_hash] = bid
        self.stats.insertions += 1
        return True

    # ------------------------------------------------------------ evict
    def evictable(self) -> int:
        return sum(1 for bid in self._map.values()
                   if self.allocator.refcount(bid) == 1)

    def evict(self, n_blocks: int) -> int:
        """Drop up to ``n_blocks`` pages held only by the cache, LRU first.
        Returns how many were reclaimed.  With a spill tier attached the
        cold page's rows are copied to host storage first, so a later
        ``match`` on its chain hash can page it back in instead of
        re-prefilling."""
        reclaimed = 0
        for h in list(self._map):
            if reclaimed >= n_blocks:
                break
            bid = self._map[h]
            if self.allocator.refcount(bid) == 1:
                if self._spill_out is not None:
                    hid = self._spill_out(bid)
                    if hid is not None:
                        self._spilled[h] = hid
                        self.stats.spills += 1
                        while len(self._spilled) > self._spill_cap:
                            _, old = self._spilled.popitem(last=False)
                            self._drop(old)
                del self._map[h]
                self.allocator.decref(bid)
                self.stats.evictions += 1
                reclaimed += 1
        return reclaimed


# ================================================================= storage


@dataclass
class SwapStats:
    swap_out_pages: int = 0   # pages copied device -> host
    swap_in_pages: int = 0    # pages copied host -> device
    dropped_pages: int = 0    # host pages released without a swap-in
    peak_in_use: int = 0


class HostSwapPool:
    """Host-memory swap tier for device KV pages.

    The second rung of the KV memory hierarchy: preempted requests park
    their written pages here instead of discarding them (readmission swaps
    them back in, skipping the re-prefill), and cold prefix-cache pages
    evicted under allocator pressure spill here so a later match can page
    them in.  Storage is per-page ``(layers, block_size, kv, hd)`` numpy
    copies keyed by a monotonically increasing host id; entries are
    refcounted like device pages so the property tests can assert the
    tier never leaks.

    ``capacity`` bounds the resident page count; a full tier makes
    ``put`` return ``None`` and the caller falls back to recompute — the
    swap pathway degrades, it never breaks correctness.
    """

    def __init__(self, capacity: int | None, block_size: int):
        if capacity is not None and capacity < 0:
            # capacity 0 is legal: an always-full tier, every put declined
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self.block_size = block_size
        self._store: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._ref: dict[int, int] = {}
        self._next = 0
        self.stats = SwapStats()

    # ------------------------------------------------------------ queries
    @property
    def in_use(self) -> int:
        return len(self._store)

    def refcount(self, hid: int) -> int:
        return self._ref.get(hid, 0)

    # ---------------------------------------------------------- lifecycle
    def put(self, k_rows: np.ndarray, v_rows: np.ndarray) -> int | None:
        """Store one page of KV rows; returns its host id with refcount 1,
        or ``None`` when the tier is at capacity."""
        if self.capacity is not None and len(self._store) >= self.capacity:
            return None
        hid = self._next
        self._next += 1
        self._store[hid] = (np.array(k_rows, copy=True),
                            np.array(v_rows, copy=True))
        self._ref[hid] = 1
        self.stats.swap_out_pages += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        return hid

    def get(self, hid: int) -> tuple[np.ndarray, np.ndarray]:
        if hid not in self._store:
            raise BlockAllocatorError(f"get of unknown host page {hid}")
        return self._store[hid]

    def incref(self, hid: int) -> None:
        if hid not in self._ref:
            raise BlockAllocatorError(f"incref on unknown host page {hid}")
        self._ref[hid] += 1

    def decref(self, hid: int, *, swapped_in: bool = False) -> None:
        ref = self._ref.get(hid)
        if ref is None:
            raise BlockAllocatorError(f"free of unknown host page {hid}")
        self._ref[hid] = ref - 1
        if self._ref[hid] == 0:
            del self._ref[hid]
            del self._store[hid]
            if swapped_in:
                self.stats.swap_in_pages += 1
            else:
                self.stats.dropped_pages += 1

    def check(self) -> None:
        """Invariant audit: storage and refcounts cover the same ids, all
        refcounts positive, capacity respected."""
        assert set(self._store) == set(self._ref)
        assert all(r >= 1 for r in self._ref.values())
        if self.capacity is not None:
            assert len(self._store) <= self.capacity


class DevicePageView:
    """Device-resident page pool + per-slot page tables for the
    paged-attention kernel (``kernels.paged_attention``).

    The pool tensors ``k``/``v`` — ``(layers, num_blocks, block_size, kv,
    hd)`` on the engine's device — ARE the KV storage on the paged path:
    the step writes fresh rows into them through the page table and
    attends every page through the same table, so prefix sharing is pure
    metadata (a shared page appears in many slots' table rows) and
    registration copies nothing.

    The step updates the pool **in place**.  The reference's JAX pool is
    immutable: it is donated to each step and re-adopted from the step's
    output.  Here the view owns the same two tensors for its whole life,
    so ``adopt`` has nothing to do.

    ``page_table`` is the host mirror the engine keeps in sync with the
    ``BlockAllocator``: ``bind_slot`` installs a slot's ordered physical
    pages when the allocator hands them out at admission, ``clear_slot``
    zeroes the row when the pages are released (finish / cancel /
    preempt).  Cleared and padding entries hold page 0 — an always-valid
    index the kernel masks by sequence length, never an out-of-bounds
    read.

    ``read_page``/``write_page`` move one page between the pool and the
    host swap tier.  Host copies are numpy arrays; bf16 travels as its
    raw 16 bits (numpy has no bfloat16), so a swap round trip is exact.
    """

    def __init__(self, num_blocks: int, block_size: int, layers: int,
                 n_kv: int, head_dim: int, dtype: torch.dtype, *, slots: int,
                 max_pages: int, device: str | torch.device):
        shape = (layers, num_blocks, block_size, n_kv, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.block_size = block_size
        self.max_pages = max_pages
        self.page_table = np.zeros((slots, max_pages), np.int32)

    # ------------------------------------------------------------- tables
    def bind_slot(self, slot: int, blocks: Sequence[int]) -> None:
        if len(blocks) > self.max_pages:
            raise BlockAllocatorError(
                f"slot {slot}: {len(blocks)} pages exceed the table's "
                f"{self.max_pages}")
        self.page_table[slot] = 0
        self.page_table[slot, :len(blocks)] = blocks

    def clear_slot(self, slot: int) -> None:
        self.page_table[slot] = 0

    # -------------------------------------------------------------- pools
    def cache(self) -> dict:
        """The pool as the paged step's cache tree."""
        return {"paged": {"k": self.k, "v": self.v}}

    def adopt(self, cache: dict) -> None:
        """No-op: the step wrote ``self.k``/``self.v`` in place (the
        reference re-owns the arrays its jitted step returns)."""

    # ---------------------------------------------------------- swap tier
    def read_page(self, bid: int) -> tuple[np.ndarray, np.ndarray]:
        """One page ``(layers, block_size, kv, hd)`` of K and V, on host."""
        return self._host(self.k[:, bid]), self._host(self.v[:, bid])

    def write_page(self, bid: int, k_rows: np.ndarray,
                   v_rows: np.ndarray) -> None:
        """Overwrite one page in place from a ``read_page`` copy."""
        self.k[:, bid] = self._device(k_rows)
        self.v[:, bid] = self._device(v_rows)

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        t = t.cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()

    def _device(self, rows: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(rows))
        if self.k.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(self.k.device)


def pages_for(n_tokens: int, block_size: int) -> int:
    """Pages needed to hold ``n_tokens`` KV rows."""
    return -(-max(n_tokens, 0) // block_size)
