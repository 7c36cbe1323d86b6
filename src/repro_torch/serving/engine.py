"""Serving engines: weights-resident prefill/decode with KV caches — the
port of ``repro.serving.engine``.

This is what an HPC-Whisk invoker hosts on a harvested node: the engine is
built once per pilot job and then answers seconds-long generate calls until
SIGTERM.

:class:`ServingEngine`
    run-to-completion ``generate`` on one request batch (the sequential
    baseline).
:class:`ContinuousEngine`
    slot-based continuous batching: each arriving request is prefilled at
    batch 1 and grafted into a free slot's row of one live cache; every
    active slot advances with ONE batched ``decode_step`` per token using a
    per-slot position vector; freed slots refill without stopping the loop;
    ``drain()`` hands back partial generations that resume on re-``add()``.
:class:`PagedContinuousEngine`
    the same lifecycle over a block-paged KV pool with prefix sharing,
    parked resume and preemption when the pool runs dry
    (``repro_torch.serving.kvcache``).

All take ``device=None`` (the card) and raise rather than fall back to the
CPU; pass ``device="cpu"`` for the CPU. :class:`ContinuousEngine` also takes
a tensor-parallel group ``tp`` (``distributed.tensor_parallel``): every rank
builds the engine over its shard of the weights, runs the same schedule,
and takes the token rank 0 picks.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.tensor_parallel import broadcast_, tp_local, tp_size
from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.models.decode_graphs import DecodeGraphs, graphable
from repro_torch.serving.batching import GenRequest, SlotBatcher
from repro_torch.serving.kvcache import OutOfBlocks, PagedKVCache, gather_pool
from repro_torch.serving.slot_state import SlotBatchState


def _pick(logits: torch.Tensor, vocab_size: int, temperature: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Next token over the un-padded vocab. logits: (B,Vpad) -> (B,1).
    Greedy ties go to the first maximum, as ``jnp.argmax`` does."""
    logits = logits[..., :vocab_size]
    if temperature <= 0:
        nxt = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return nxt[:, None]


def _on_device(params, cfg: ModelConfig, device: torch.device):
    """Check that every parameter lies on ``device``, then make the
    compute-dtype copies once (:func:`repro_torch.models.model.cast_params`)."""
    for leaf in model_mod.tree_leaves(params):
        if leaf.device.type != device.type:
            raise ValueError(f"parameters on {leaf.device}, engine on {device}: "
                             f"load them with device={device.type!r}")
    return model_mod.cast_params(params, cfg)


def _check_decoder(cfg: ModelConfig) -> None:
    if not cfg.is_autoregressive:
        raise ValueError(f"arch {cfg.arch_id!r} is encoder-only: it is "
                         f"scored, not decoded")


_CACHE_BUCKET = 64  # sequential-path caches sized in buckets, not max_seq


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, max_seq: int = 512,
                 device: DeviceLike = None):
        _check_decoder(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _on_device(params, cfg, self.device)
        self.max_seq = max_seq
        self.peak_cache_bytes = 0

    def _grown_cache(self, cache, batch: int, seq_cap: Optional[int] = None):
        """Pad a prefill cache up to ``(batch, seq_cap)`` (``max_seq`` when
        not given): every mismatched axis is padded with zeros, none shrunk."""
        full = model_mod.init_cache(self.cfg, batch,
                                    self.max_seq if seq_cap is None else seq_cap,
                                    self.device)

        def graft(z, c):
            if z.shape == c.shape:
                return c.to(z.dtype)
            if z.ndim != c.ndim or any(ci > zi for zi, ci in zip(z.shape, c.shape)):
                raise ValueError(f"cannot grow cache leaf {tuple(c.shape)} to "
                                 f"{tuple(z.shape)}")
            z[tuple(slice(0, n) for n in c.shape)] = c.to(z.dtype)
            return z
        return model_mod.tree_map(graft, full, cache)

    def generate(self, tokens: np.ndarray, n_new: int,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Greedy (or sampled) generation. tokens: (B, S) prompt -> (B, n_new)."""
        b, s = tokens.shape
        if s + n_new > self.max_seq:
            raise ValueError(f"prompt {s} + n_new {n_new} > max_seq {self.max_seq}")
        seq_cap = min(self.max_seq, -(-(s + n_new) // _CACHE_BUCKET) * _CACHE_BUCKET)
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=self.device)
        logits, cache = model_mod.prefill(self.params, {"tokens": tok}, self.cfg)
        cache = self._grown_cache(cache, b, seq_cap)
        self.peak_cache_bytes = max(self.peak_cache_bytes, model_mod.nbytes(cache))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = [self._pick(logits, temperature, gen)]
        for i in range(1, n_new):
            logits, cache = model_mod.decode_step(self.params, out[-1], cache,
                                                  s + i - 1, self.cfg)
            out.append(self._pick(logits, temperature, gen))
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)

    def _pick(self, logits, temperature, generator):
        return _pick(logits, self.cfg.vocab_size, temperature, generator)

    def score(self, tokens: np.ndarray) -> float:
        """Mean NLL of a token batch through ``loss_fn`` (a cheap integrity
        check when an invoker re-registers after migration). As in
        ``repro``, the batch is ``tokens[:, :-1]`` labelled with
        ``tokens[:, 1:]``, and ``loss_fn`` shifts them once more."""
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=self.device)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        loss, _ = model_mod.loss_fn(self.params, batch, self.cfg)
        return float(loss)


class ContinuousEngine:
    """Continuous-batching decode: ``n_slots`` requests in flight at once,
    one batched ``decode_step`` per emitted token wave.

    Per-slot bookkeeping lives on the host (``positions``/``last_tok``); the
    decode state is one :class:`SlotBatchState` tree of batch ``n_slots`` on
    the device. Temperature-0 outputs are token-identical to the sequential
    :meth:`ServingEngine.generate` path.

    Under a tensor-parallel group ``tp`` (its ``device`` is the engine's)
    ``params`` is this rank's shard and the cache holds the rank's KV heads.
    Every rank of the group makes the same calls in the same order; rank 0
    picks each token from the whole logits (every rank draws from a
    generator seeded alike, so the generators stay equal) and broadcasts
    it, so no rank can drift from another on a tie.
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 max_seq: int = 512, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None, tp=None):
        _check_decoder(cfg)
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} must be >= 1")
        tp_local(cfg, tp)   # an architecture tp does not cover raises
        self.cfg = cfg
        self.tp = tp
        self.device = resolve_device(device if tp is None else tp.device)
        # the batched decode replays CUDA graphs where it can (DecodeGraphs)
        self._graphable = graphable(cfg, self.device, tp)
        self.params = _on_device(params, cfg, self.device)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.temperature = temperature
        self.batcher = SlotBatcher(n_slots)
        self.positions = np.zeros(n_slots, np.int64)  # pos of last_tok per slot
        self.last_tok = np.zeros((n_slots, 1), np.int64)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # counters for occupancy/throughput accounting
        self.n_decode_steps = 0
        self.n_emitted = 0       # tokens produced (prefill-picked + decoded)
        self.n_slot_steps = 0    # sum over steps of active slots
        self.prefill_tokens = 0  # context tokens pushed through prefill
        self._init_cache_state()

    def _init_cache_state(self):
        """Allocate the slot-state tree; the paged subclass swaps in a block
        pool instead."""
        self._slot_state = SlotBatchState(self.cfg, self.n_slots, self.max_seq,
                                          self.device, self.tp)

    @property
    def params(self):
        """The compute-dtype weights. Settable: a new tree drops the decode
        graphs, which the next step captures again."""
        return self._params

    @params.setter
    def params(self, tree):
        self._params = tree
        self._graphs = None

    @property
    def cache(self):
        """The live decode-state tree. Settable, for callers that transplant
        it wholesale; a new tree drops the decode graphs, as ``params``
        does."""
        if self._slot_state is None:
            raise AttributeError(
                "paged engine keeps decode state in the block pool (.kv), "
                "not a dense slot-state tree")
        return self._slot_state.tree

    @cache.setter
    def cache(self, tree):
        self._slot_state.tree = tree
        self._graphs = None

    @property
    def device_state(self):
        """Device-resident decode state (for synchronising at timing
        boundaries). Unlike ``cache`` this is defined for every engine
        flavour (the paged subclass returns its block pools)."""
        return self._slot_state.tree

    # --- request lifecycle ----------------------------------------------------
    def add(self, req: GenRequest):
        """Admit a request: queue it and prefill any slot it (or a cascade of
        early-EOS admissions) frees up. Safe to call mid-decode."""
        for slot in self.batcher.add(req):
            self._admit(slot)

    def _admit(self, slot: int):
        req = self.batcher.slots[slot]
        while req is not None:
            with spans.span("engine.admit", req.id):
                if req.remaining == 0:   # resumed partial that was already full
                    req.done = True
                    self.batcher.finished.append(req)
                    self.batcher.slots[slot] = None
                    self._reap()
                else:
                    context = list(req.prompt) + list(req.generated)
                    if len(context) + req.remaining > self.max_seq:
                        raise ValueError(
                            f"request {req.id}: context {len(context)} + remaining "
                            f"{req.remaining} > max_seq {self.max_seq}")
                    logits = self._context_into_slot(slot, req, context)
                    if logits is None:
                        # mid-decode state restored (paged parked resume) or the
                        # request requeued: no admission token from here
                        return
                    tok = int(self._pick_row(logits)[0, 0])
                    req.generated.append(tok)
                    self.n_emitted += 1
                    self.positions[slot] = len(context)
                    self.last_tok[slot, 0] = tok
                    finished = self.batcher._finish_if_done(slot, req, tok, self.eos_id)
                    self._reap()
                    if not finished:
                        return
            self.batcher._fill()
            req = self.batcher.slots[slot]

    def _context_into_slot(self, slot: int, req: GenRequest,
                           context: List[int]) -> Optional[torch.Tensor]:
        """Install ``context``'s KV into ``slot``: prefill at batch 1 and
        graft. Returns the last-position logits (1, Vpad), or None when no
        admission token should be emitted (the paged engine's parked resume
        and requeue)."""
        logits, pre = self._prefill(context)
        self._slot_state.graft(pre, slot)
        self.prefill_tokens += len(context)
        return logits

    def _prefill(self, context: List[int]):
        tok = torch.as_tensor([context], dtype=torch.int64, device=self.device)
        return model_mod.prefill(self.params, {"tokens": tok}, self.cfg, self.tp)

    def _reap(self):
        """Release per-request KV state of newly finished requests (no-op
        for the dense layout: slot rows are simply overwritten)."""

    def register_prefix(self, tokens: List[int]) -> bool:
        """Pre-install a shared context prefix. The dense layout has no
        sharing to exploit; returns False so callers can skip it."""
        return False

    def _pick_row(self, logits: torch.Tensor) -> np.ndarray:
        with spans.span("engine.pick"):
            gen = self._gen if self.temperature > 0 else None
            toks = _pick(logits, self.cfg.vocab_size, self.temperature, gen)
            if tp_size(self.tp) > 1:
                toks = broadcast_(toks.contiguous(), self.tp, src=0)
            return toks.cpu().numpy()

    def step(self) -> int:
        """One batched decode: every active slot advances one token; finished
        slots are refilled (and prefilled) without stopping the loop. Returns
        the number of tokens emitted."""
        with spans.span("engine.step", self.n_decode_steps):
            if not self.batcher.active():
                return 0
            pos = np.minimum(self.positions, self.max_seq - 1)
            logits = self._decode_active(pos)
            # re-read: a paged wave may have preempted a slot to reclaim memory
            active = self.batcher.active()
            toks = self._pick_row(logits)  # (n_slots, 1)
            self.n_decode_steps += 1
            self.n_slot_steps += len(active)
            slot_of = {req.id: i for i, req in active.items()}

            def emit(req: GenRequest) -> int:
                i = slot_of[req.id]
                self.positions[i] += 1
                self.last_tok[i, 0] = toks[i, 0]
                return int(toks[i, 0])

            filled = self.batcher.step(emit, eos_id=self.eos_id)
            self.n_emitted += len(active)
            self._reap()
            for slot in filled:
                self._admit(slot)
            return len(active)

    def _decode_active(self, pos: np.ndarray) -> torch.Tensor:
        """One batched decode over every slot row; returns (n_slots, Vpad)
        logits and advances the KV state in place. Where the model can be
        graphed (``decode_graphs.graphable``) the step replays the
        :class:`DecodeGraphs` that its first step captured, and reads the
        tokens and positions from their buffers; a capture that fails says
        so once, and every later step runs eagerly."""
        if self._graphs is None and self._graphable:
            self._graphs = DecodeGraphs(self.params, self.cache, self.cfg, self.n_slots,
                                        self.device)
        if self._graphs is None:
            logits, _ = model_mod.decode_step(
                self.params, torch.as_tensor(self.last_tok, device=self.device),
                self.cache, torch.as_tensor(pos, device=self.device), self.cfg, self.tp)
            return logits
        self._graphs.load(self.last_tok, pos)
        logits = self._graphs.step()
        if self._graphs.failed:
            print(f"ContinuousEngine: the decode step could not be captured in CUDA graphs "
                  f"({self._graphs.failed}); decoding eagerly from here on", file=sys.stderr)
            self._graphable = False
            self._graphs = None
        return logits

    def run(self) -> List[GenRequest]:
        """Drive to quiescence; returns (and clears) the finished list."""
        while self.batcher.active():
            self.step()
        done, self.batcher.finished = self.batcher.finished, []
        return done

    def serve(self, gens: List[GenRequest]) -> Dict[int, float]:
        """Admit ``gens`` and run to quiescence, timing each request: returns
        ``{request id -> completion offset in wall seconds}`` (prefill
        included). Every step ends by copying the picked tokens to the host,
        which waits for the device, so the offsets are device-complete. The
        finished requests stay on ``batcher.finished``."""
        t0 = time.perf_counter()
        finished_at: Dict[int, float] = {}

        def sweep():
            now = time.perf_counter() - t0
            for f in self.batcher.finished:
                finished_at.setdefault(f.id, now)

        for g in gens:
            self.add(g)
            sweep()
        while self.batcher.active():
            self.step()
            sweep()
        return finished_at

    def drain(self) -> List[GenRequest]:
        """SIGTERM hand-off: stop decoding and return all unfinished requests
        with their partial ``generated`` intact, so a resubmit resumes them
        instead of restarting."""
        return self.batcher.drain()

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        if self.n_decode_steps == 0:
            return float("nan")
        return self.n_slot_steps / (self.n_decode_steps * self.n_slots)

    def kv_stats(self) -> Dict[str, float]:
        """KV-memory accounting with the same keys as ``repro``'s engines.
        The dense layout reserves everything up front, hence high-water ==
        total."""
        total = model_mod.nbytes(self.cache)
        used = int(sum(int(self.positions[i]) + 1 for i in self.batcher.active()))
        return {
            "layout": "dense",
            "pool_bytes": total,
            "bytes_in_use": total,
            "bytes_high_water": total,
            "blocks_total": self.n_slots,       # a dense "block" is one row
            "blocks_in_use": len(self.batcher.active()),
            "blocks_high_water": self.n_slots,
            "tokens_in_use": used,
            "capacity_tokens": self.n_slots * self.max_seq,
            "cow_copies": 0,
            "prefill_tokens": self.prefill_tokens,
            "shared_tokens": 0,
            "resumed_tokens": 0,
            "share_hits": 0,
            "resume_hits": 0,
            "mem_preempts": 0,
            "share_hit_rate": 0.0,
        }


def _paged_gather_decode(params, token: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, tables: torch.Tensor, pos: torch.Tensor,
                         cfg: ModelConfig, seg_name: str, s_max: int):
    """Gather-path paged decode: reassemble a dense-layout copy of the cache
    from the block tables and run the stock ``decode_step`` on it — the
    dense engine's math (garbage past each row's length is masked by the
    per-row position mask). Returns the wave's logits plus the K/V entries
    written at ``pos``, (L, B, KV, Dh) each, for the caller to scatter back
    into the pool."""
    cache = {seg_name: {"k": gather_pool(k_pool, tables, s_max),
                        "v": gather_pool(v_pool, tables, s_max)}}
    logits, cache = model_mod.decode_step(params, token, cache, pos, cfg)
    rows = torch.arange(tables.shape[0], device=tables.device)
    return logits, cache[seg_name]["k"][:, rows, pos], cache[seg_name]["v"][:, rows, pos]


class PagedContinuousEngine(ContinuousEngine):
    """Continuous batching over a block-paged KV cache — the port of
    ``repro.serving.engine.PagedContinuousEngine``.

    Same request lifecycle and token streams as :class:`ContinuousEngine`
    (temperature-0 outputs are identical on the default gather attention
    path), but KV memory is a pool of fixed-size blocks shared by refcount:

    * admission writes the context's K/V into just ``ceil(len/bs)`` blocks
      instead of reserving a full ``max_seq`` row;
    * a registered per-tenant prefix (:meth:`register_prefix`) is prefilled
      once and forked into every request that starts with it — shared blocks
      are referenced, not copied, and the first divergent write into a
      partially-filled tail block copy-on-writes;
    * :meth:`drain` parks each in-flight request's blocks (pinned under its
      request id) so a later resume re-references them instead of
      re-prefilling;
    * when the pool runs dry, admission requeues and decode waves preempt
      the highest slot back to the waiting queue (parked sequences are
      evicted first) — requests queue, memory never corrupts.

    ``attn="gather"`` reassembles a dense copy per wave (reference oracle);
    ``attn="kernel"`` runs :func:`repro_torch.models.model.paged_decode_step`,
    whose attention reads K/V through the block tables inside the CUDA
    paged-attention kernel (its plain version on the CPU).
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 max_seq: int = 512, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0, *,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 attn: str = "gather", max_parked: int = 64,
                 device: DeviceLike = None):
        if attn not in ("gather", "kernel"):
            raise ValueError(
                f"PagedContinuousEngine: unknown attn={attn!r}; allowed "
                f"values: ('gather', 'kernel')")
        if max_seq % block_size != 0:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"block_size={block_size}")
        self.block_size = block_size
        self.max_blocks = max_seq // block_size
        if n_blocks is None:
            # dense-equivalent capacity + the null block
            n_blocks = n_slots * self.max_blocks + 1
        self.n_blocks = n_blocks
        self.attn = attn
        self.max_parked = max_parked
        super().__init__(cfg, params, n_slots, max_seq, eos_id, temperature,
                         seed, device=device)

    @property
    def device_state(self):
        return (self.kv.k_pool, self.kv.v_pool)

    def _init_cache_state(self):
        self._slot_state = None   # state lives in the block pool, not a tree
        self.kv = PagedKVCache(self.cfg, self.n_blocks, self.block_size,
                               device=self.device)
        self._slot_seq: List[Optional[Hashable]] = [None] * self.n_slots
        self._parked: Dict[int, Tuple[int, ...]] = {}   # req.id -> context
        self._prefixes: Dict[Tuple[int, ...], Hashable] = {}
        self.shared_tokens = 0     # context tokens satisfied by a prefix fork
        self.resumed_tokens = 0    # context tokens satisfied by parked blocks
        self.share_hits = 0
        self.resume_hits = 0
        self.n_mem_preempts = 0
        (seg,) = transformer.segments_for(self.cfg)  # paged_compatible: one dense segment
        self._seg_name = seg.name

    # --- one paged decode wave ------------------------------------------------
    def _decode_paged(self, token, tables, pos, bids, offs) -> torch.Tensor:
        """Run one decode wave (any batch) against the pool, writing each
        row's new K/V entry into its reserved ``(bids, offs)`` slot."""
        dev = self.device
        token = torch.as_tensor(token, dtype=torch.int64, device=dev)
        tables = torch.as_tensor(tables, dtype=torch.int64, device=dev)
        pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
        if self.attn == "kernel":
            logits, _, _ = model_mod.paged_decode_step(
                self.params, token, self.kv.k_pool, self.kv.v_pool, tables, pos,
                bids, offs, self.cfg)
        else:
            logits, k_ent, v_ent = _paged_gather_decode(
                self.params, token, self.kv.k_pool, self.kv.v_pool, tables, pos,
                self.cfg, self._seg_name, self.max_seq)
            self.kv.write_tokens(bids, offs, k_ent, v_ent)
        return logits

    # --- admission ------------------------------------------------------------
    def _context_into_slot(self, slot: int, req: GenRequest,
                           context: List[int]) -> Optional[torch.Tensor]:
        key = ("req", req.id)
        parked = self._parked.pop(req.id, None)
        if key in self.kv.alloc.tables:
            n_keep = len(context) - 1
            if (parked is not None and 0 <= n_keep <= self.kv.length(key)
                    and parked[:len(context)] == tuple(context)):
                # drained blocks were pinned: re-reference them and restore
                # the mid-decode state (cache holds 0..n_keep-1, context[-1]
                # pending) — the next token comes from step(), identical
                # to never having drained
                self.kv.trim(key, n_keep)
                self._slot_seq[slot] = key
                self.positions[slot] = n_keep
                self.last_tok[slot, 0] = context[-1]
                self.resume_hits += 1
                self.resumed_tokens += n_keep
                return None
            self.kv.free(key)   # diverged/stale park: fall through to fresh
        toks = tuple(context)
        best_n, best_seq = 0, None
        for ptoks, pseq in self._prefixes.items():
            n = len(ptoks)
            if best_n < n <= len(context) - 1 and toks[:n] == ptoks:
                best_n, best_seq = n, pseq
        while True:
            try:
                if best_seq is not None:
                    self.kv.fork(best_seq, key, best_n)
                    logits = self._extend(key, context, best_n)
                    self.share_hits += 1       # only successful installs count
                    self.shared_tokens += best_n
                else:
                    self.kv.create(key)
                    logits = self._install_prefill(key, context)
                self._slot_seq[slot] = key
                return logits
            except OutOfBlocks:
                if key in self.kv.alloc.tables:
                    self.kv.free(key)
                if self._evict_parked():
                    continue
                others = [j for j in self.batcher.active() if j != slot]
                if not others:
                    raise   # nothing to wait for: the pool is simply too small
                # requeue at the head: a finishing slot will retry the admit
                self.batcher.slots[slot] = None
                self.batcher.waiting.insert(0, req)
                return None

    def _install_prefill(self, key, context: List[int]) -> torch.Tensor:
        need = -(-len(context) // self.block_size)
        if len(self.kv.alloc.free_list) < need:   # fail before the device
            raise OutOfBlocks(f"need {need} blocks for admission, "
                              f"{len(self.kv.alloc.free_list)} free")
        logits, pre = self._prefill(context)
        seg = pre[self._seg_name]
        self.kv.write_prefill(key, seg["k"][:, 0], seg["v"][:, 0])
        self.prefill_tokens += len(context)
        return logits

    def _extend(self, key, context: List[int], start: int) -> Optional[torch.Tensor]:
        """Append ``context[start:]`` through the paged decode path (the
        forked prefix supplies positions ``0..start-1``), one token per wave
        at batch 1 — exactly the math decode would have run, so the suffix's
        K/V (and the admission token) match an unshared install."""
        logits = None
        for p in range(start, len(context)):
            bid, off = self.kv.append(key)
            logits = self._decode_paged(
                [[context[p]]], self.kv.table_array([key], self.max_blocks),
                [p], [bid], [off])
            self.prefill_tokens += 1
        return logits

    # --- decode wave ----------------------------------------------------------
    def _decode_active(self, pos: np.ndarray) -> torch.Tensor:
        bids = np.zeros(self.n_slots, np.int64) + self.kv.null_block
        offs = np.zeros(self.n_slots, np.int64)
        seqs: List[Hashable] = [self.kv.NULL_SEQ] * self.n_slots
        pos = np.asarray(pos).copy()
        i = 0
        while i < self.n_slots:
            if self.batcher.slots[i] is None:
                pos[i] = 0
                i += 1
                continue
            try:
                bids[i], offs[i] = self.kv.append(self._slot_seq[i])
            except OutOfBlocks:
                if self._evict_parked():
                    continue
                victim = self._pick_victim(i)
                if victim is None:
                    raise
                self._preempt_slot(victim)
                continue    # slot i unchanged unless it was its own victim
            seqs[i] = self._slot_seq[i]
            i += 1
        tables = self.kv.table_array(seqs, self.max_blocks)
        return self._decode_paged(self.last_tok, tables, pos, bids, offs)

    def _pick_victim(self, min_slot: int) -> Optional[int]:
        """Memory-pressure victim: the highest-index active slot at or above
        ``min_slot`` — slots below it already appended this wave and must
        keep their reservation."""
        for j in range(self.n_slots - 1, min_slot - 1, -1):
            if self.batcher.slots[j] is not None:
                return j
        return None

    def _preempt_slot(self, j: int):
        """Hand slot ``j``'s request (partial generation intact) back to the
        head of the waiting queue and release its blocks; a later admission
        re-prefills its context."""
        req = self.batcher.slots[j]
        self.batcher.slots[j] = None
        self.batcher.waiting.insert(0, req)
        self.kv.free(self._slot_seq[j])
        self._slot_seq[j] = None
        self.n_mem_preempts += 1

    def _evict_parked(self) -> bool:
        """Free the oldest parked sequence's blocks; True if one existed."""
        if not self._parked:
            return False
        rid = next(iter(self._parked))
        del self._parked[rid]
        self.kv.free(("req", rid))
        return True

    # --- lifecycle ------------------------------------------------------------
    def _reap(self):
        for req in self.batcher.finished:
            key = ("req", req.id)
            self._parked.pop(req.id, None)
            if key in self.kv.alloc.tables:
                self.kv.free(key)
        for i in range(self.n_slots):
            if self.batcher.slots[i] is None:
                self._slot_seq[i] = None

    def drain(self) -> List[GenRequest]:
        # pin each in-flight request's blocks under its id: the sequence
        # stays in the allocator until resumed, evicted, or finished
        for req in self.batcher.active().values():
            self._parked[req.id] = tuple(req.prompt) + tuple(req.generated)
        out = super().drain()
        self._slot_seq = [None] * self.n_slots
        while len(self._parked) > self.max_parked:
            self._evict_parked()
        return out

    def register_prefix(self, tokens: List[int]) -> bool:
        """Prefill a shared context prefix once; later admissions whose
        context starts with it fork its blocks instead of re-prefilling."""
        toks = tuple(int(t) for t in tokens)
        if not toks:
            return False
        if toks in self._prefixes:
            return True
        if len(toks) >= self.max_seq:
            raise ValueError(f"prefix of {len(toks)} tokens >= max_seq {self.max_seq}")
        key = ("prefix", len(self._prefixes))
        self.kv.create(key)
        try:
            _, pre = self._prefill(list(toks))
            seg = pre[self._seg_name]
            self.kv.write_prefill(key, seg["k"][:, 0], seg["v"][:, 0])
        except OutOfBlocks:
            self.kv.free(key)
            return False
        self.prefill_tokens += len(toks)
        self._prefixes[toks] = key
        return True

    def kv_stats(self) -> Dict[str, float]:
        st = self.kv.stats()
        denom = self.prefill_tokens + self.shared_tokens + self.resumed_tokens
        reused = self.shared_tokens + self.resumed_tokens
        st.update({
            "layout": "paged",
            "tokens_in_use": int(sum(
                self.kv.length(s) for s in self.kv.alloc.tables
                if s != self.kv.NULL_SEQ)),
            "capacity_tokens": (self.n_blocks - 1) * self.block_size,
            "prefill_tokens": self.prefill_tokens,
            "shared_tokens": self.shared_tokens,
            "resumed_tokens": self.resumed_tokens,
            "share_hits": self.share_hits,
            "resume_hits": self.resume_hits,
            "mem_preempts": self.n_mem_preempts,
            "share_hit_rate": reused / denom if denom else 0.0,
        })
        return st
