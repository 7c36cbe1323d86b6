"""Block-paged KV cache with ref-counted copy-on-write prefix sharing — the
port of ``repro.serving.kvcache``.

The dense ``ContinuousEngine`` reserves ``n_slots x max_seq`` cache rows up
front, so slot count is bounded by the longest possible sequence. Here K/V
live in fixed-size blocks of one preallocated pool, each sequence holds a
table of block ids, and a free-list allocator returns blocks the moment a
slot is released. Ref-counting lets many sequences reference the same
physical blocks (a per-tenant prefix is prefilled once and forked into every
request that shares it); a write into a shared block copies it first.

:class:`BlockAllocator`, :class:`OutOfBlocks` and :func:`paged_compatible`
are copies of ``repro``'s host-side code (the port imports nothing of
``repro``). :class:`PagedKVCache` keeps the pools as torch tensors on one
device and updates them in place (saves a copy of both pools per write).
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


class OutOfBlocks(RuntimeError):
    """The pool has no free block — callers queue or preempt, never corrupt."""


class BlockAllocator:
    """Host-side free-list allocator with ref-counted block sharing.

    A *sequence* (any hashable key) owns an ordered block table; position
    ``p`` of the sequence lives in ``table[p // block_size]`` at offset
    ``p % block_size``. ``fork`` makes a new sequence share a prefix of an
    existing one by increfing its blocks; ``append_pos`` reserves the next
    position and reports when the caller must copy a shared block first
    (copy-on-write).
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1 or block_size < 1:
            raise ValueError(f"n_blocks={n_blocks} and "
                             f"block_size={block_size} must both be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.refcount = np.zeros(n_blocks, np.int64)
        self.free_list: List[int] = list(range(n_blocks - 1, -1, -1))
        self.tables: Dict[Hashable, List[int]] = {}
        self.lengths: Dict[Hashable, int] = {}
        self.high_water = 0     # max blocks ever simultaneously in use
        self.cow_copies = 0

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self.free_list)

    def alloc_block(self) -> int:
        if not self.free_list:
            raise OutOfBlocks(f"pool of {self.n_blocks} blocks exhausted")
        bid = self.free_list.pop()
        assert self.refcount[bid] == 0, bid
        self.refcount[bid] = 1
        self.high_water = max(self.high_water, self.blocks_in_use)
        return bid

    def decref(self, bid: int):
        assert self.refcount[bid] > 0, f"double free of block {bid}"
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            self.free_list.append(bid)

    # --- sequence lifecycle ---------------------------------------------------
    def create(self, seq: Hashable):
        assert seq not in self.tables, seq
        self.tables[seq] = []
        self.lengths[seq] = 0

    def free(self, seq: Hashable):
        for bid in self.tables.pop(seq):
            self.decref(bid)
        del self.lengths[seq]

    def fork(self, src: Hashable, dst: Hashable,
             n_tokens: Optional[int] = None):
        """``dst`` shares ``src``'s first ``n_tokens`` positions (default:
        all of them) by referencing the same physical blocks — no copy. A
        later append into a shared (partial) last block copy-on-writes."""
        n = self.lengths[src] if n_tokens is None else n_tokens
        assert 0 <= n <= self.lengths[src], (n, self.lengths[src])
        self.create(dst)
        nb = -(-n // self.block_size)
        for bid in self.tables[src][:nb]:
            self.refcount[bid] += 1
            self.tables[dst].append(bid)
        self.lengths[dst] = n

    def append_pos(self, seq: Hashable) -> Tuple[int, int, Optional[int]]:
        """Reserve the next position of ``seq``. Returns ``(bid, off,
        cow_src)``; when ``cow_src`` is not None the caller must copy that
        block's payload into ``bid`` before writing (the block was shared)."""
        off = self.lengths[seq] % self.block_size
        table = self.tables[seq]
        cow_src = None
        if off == 0:
            table.append(self.alloc_block())
        elif self.refcount[table[-1]] > 1:
            cow_src = table[-1]
            table[-1] = self.alloc_block()
            self.decref(cow_src)
            self.cow_copies += 1
        self.lengths[seq] += 1
        return table[-1], off, cow_src

    def trim(self, seq: Hashable, n_tokens: int):
        """Drop positions past ``n_tokens`` (resume-bucket truncation on a
        parked sequence), releasing now-unreferenced trailing blocks."""
        assert 0 <= n_tokens <= self.lengths[seq], (n_tokens, self.lengths[seq])
        nb = -(-n_tokens // self.block_size)
        table = self.tables[seq]
        while len(table) > nb:
            self.decref(table.pop())
        self.lengths[seq] = n_tokens

    # --- invariants -----------------------------------------------------------
    def check(self):
        """Conservation: every block is either free or referenced, exactly
        refcount times, and the free list holds no duplicates."""
        refs = np.zeros(self.n_blocks, np.int64)
        for table in self.tables.values():
            for bid in table:
                refs[bid] += 1
        assert np.array_equal(refs, self.refcount), \
            (refs.tolist(), self.refcount.tolist())
        free = sorted(self.free_list)
        assert len(set(free)) == len(free), "duplicate free-list entries"
        assert free == np.flatnonzero(self.refcount == 0).tolist(), \
            (free, np.flatnonzero(self.refcount == 0).tolist())
        for seq, table in self.tables.items():
            need = -(-self.lengths[seq] // self.block_size)
            assert len(table) == need, (seq, len(table), need)


def paged_compatible(cfg: ModelConfig) -> bool:
    """The paged layout covers single-segment GQA token caches only: MLA's
    compressed cache, SSM/hybrid state, sliding-window rings, and non-token
    frontends keep the dense path."""
    return (cfg.family == "dense" and not cfg.use_mla
            and cfg.sliding_window is None and cfg.frontend is None
            and cfg.is_autoregressive)


def _index(ids, device: torch.device) -> torch.Tensor:
    """Block ids or offsets (list, numpy or tensor) as int64 on ``device``."""
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


class PagedKVCache:
    """Device-side paged KV pool for a single-segment GQA model.

    Pools are ``(n_layers, n_blocks, block_size, n_kv_heads, head_dim)`` in
    the compute dtype on ``device`` (``None`` means the card); an extra
    *null* block (owned by the reserved ``"__null__"`` sequence) is
    allocated at construction so inactive batch rows always have a valid
    write target and block tables a harmless padding id — its contents are
    garbage and always masked.
    """

    NULL_SEQ = "__null__"

    def __init__(self, cfg: ModelConfig, n_blocks: int, block_size: int,
                 dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
        if not paged_compatible(cfg):
            raise ValueError(
                f"paged KV layout not defined for family={cfg.family!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.block_size = block_size
        self.n_blocks = n_blocks
        shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
        dt = dtype or cfg.compute_dtype
        self.k_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.alloc = BlockAllocator(n_blocks, block_size)
        self.alloc.create(self.NULL_SEQ)
        self.null_block, _, _ = self.alloc.append_pos(self.NULL_SEQ)

    # --- accounting -----------------------------------------------------------
    @property
    def block_bytes(self) -> int:
        """Bytes per block across both pools and all layers."""
        l, _, bs, kv, dh = self.k_pool.shape
        return 2 * l * bs * kv * dh * self.k_pool.element_size()

    @property
    def pool_bytes(self) -> int:
        return self.n_blocks * self.block_bytes

    def stats(self) -> Dict[str, float]:
        a = self.alloc
        return {
            "blocks_total": self.n_blocks,
            "blocks_in_use": a.blocks_in_use,
            "blocks_high_water": a.high_water,
            "bytes_in_use": a.blocks_in_use * self.block_bytes,
            "bytes_high_water": a.high_water * self.block_bytes,
            "pool_bytes": self.pool_bytes,
            "cow_copies": a.cow_copies,
        }

    # --- lifecycle (delegates + device effects) -------------------------------
    def create(self, seq: Hashable):
        self.alloc.create(seq)

    def free(self, seq: Hashable):
        self.alloc.free(seq)

    def fork(self, src: Hashable, dst: Hashable,
             n_tokens: Optional[int] = None):
        self.alloc.fork(src, dst, n_tokens)

    def trim(self, seq: Hashable, n_tokens: int):
        self.alloc.trim(seq, n_tokens)

    def length(self, seq: Hashable) -> int:
        return self.alloc.lengths[seq]

    def append(self, seq: Hashable) -> Tuple[int, int]:
        """Reserve the next position, copying the tail block across all
        layers first when it is shared (the copy is queued on the stream
        before the token write of the same wave). Returns ``(bid, off)``."""
        bid, off, cow_src = self.alloc.append_pos(seq)
        if cow_src is not None:
            self.k_pool[:, bid].copy_(self.k_pool[:, cow_src])
            self.v_pool[:, bid].copy_(self.v_pool[:, cow_src])
        return bid, off

    def write_prefill(self, seq: Hashable, k: torch.Tensor, v: torch.Tensor):
        """Store a fresh prefill's K/V. k, v: (L, S, KV, Dh) for positions
        0..S-1 of ``seq`` (which must be empty)."""
        s = k.shape[1]
        assert s >= 1 and self.alloc.lengths[seq] == 0, (s, seq)
        nb = -(-s // self.block_size)
        if len(self.alloc.free_list) < nb:
            raise OutOfBlocks(f"need {nb} blocks, "
                              f"{len(self.alloc.free_list)} free")
        bids = [self.alloc.alloc_block() for _ in range(nb)]
        self.alloc.tables[seq].extend(bids)
        self.alloc.lengths[seq] = s
        ids = _index(bids, self.device)
        for pool, new in ((self.k_pool, k), (self.v_pool, v)):
            padded = pool.new_zeros((new.shape[0], nb * self.block_size) + tuple(new.shape[2:]))
            padded[:, :s] = new
            pool.index_copy_(1, ids, padded.reshape(
                new.shape[0], nb, self.block_size, *new.shape[2:]))

    def write_tokens(self, bids, offs, k_ent: torch.Tensor, v_ent: torch.Tensor):
        """Scatter one K/V entry per batch row: entries (L, B, KV, Dh) land
        at ``pool[:, bids[i], offs[i]]`` (slots from :meth:`append`)."""
        bids, offs = _index(bids, self.device), _index(offs, self.device)
        self.k_pool[:, bids, offs] = k_ent.to(self.k_pool.dtype)
        self.v_pool[:, bids, offs] = v_ent.to(self.v_pool.dtype)

    # --- reads ----------------------------------------------------------------
    def table_array(self, seqs: List[Hashable], width: int) -> np.ndarray:
        """(B, width) int32 block-table matrix, null-block padded."""
        out = np.full((len(seqs), width), self.null_block, np.int32)
        for i, seq in enumerate(seqs):
            t = self.alloc.tables[seq]
            assert len(t) <= width, (seq, len(t), width)
            out[i, :len(t)] = t
        return out

    def gather_dense(self, tables, s_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reassemble ``(L, B, s_max, KV, Dh)`` dense-layout copies of K and
        V from block tables — positions past a sequence's length hold
        garbage and must be masked by the consumer (attention already does)."""
        tables = _index(tables, self.device)
        return (gather_pool(self.k_pool, tables, s_max),
                gather_pool(self.v_pool, tables, s_max))

    def check(self):
        self.alloc.check()


def gather_pool(pool: torch.Tensor, tables: torch.Tensor, s_max: int) -> torch.Tensor:
    """pool (L,NB,BS,KV,Dh), tables (B,MAXB) -> (L,B,s_max,KV,Dh) copy."""
    l, _, bs = pool.shape[:3]
    b, maxb = tables.shape
    return pool[:, tables].reshape(l, b, maxb * bs, *pool.shape[3:])[:, :, :s_max]
