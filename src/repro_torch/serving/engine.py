"""Serving engines: weights-resident prefill/decode with KV caches — the
port of the dense half of ``repro.serving.engine``.

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

Both take ``device=None`` (the card) and raise rather than fall back to the
CPU; pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as model_mod
from repro_torch.serving.batching import GenRequest, SlotBatcher
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
        raise NotImplementedError(
            "ServingEngine.score needs forward/loss_fn, which come with a "
            "later slice of the port (ROADMAP)")


class ContinuousEngine:
    """Continuous-batching decode: ``n_slots`` requests in flight at once,
    one batched ``decode_step`` per emitted token wave.

    Per-slot bookkeeping lives on the host (``positions``/``last_tok``); the
    decode state is one :class:`SlotBatchState` tree of batch ``n_slots`` on
    the device. Temperature-0 outputs are token-identical to the sequential
    :meth:`ServingEngine.generate` path.
    """

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 max_seq: int = 512, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None):
        _check_decoder(cfg)
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
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
        self._slot_state = SlotBatchState(cfg, n_slots, max_seq, self.device)

    @property
    def cache(self):
        """The live decode-state tree. Settable, for callers that transplant
        it wholesale."""
        return self._slot_state.tree

    @cache.setter
    def cache(self, tree):
        self._slot_state.tree = tree

    @property
    def device_state(self):
        """Device-resident decode state (for synchronising at timing
        boundaries)."""
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
            if req.remaining == 0:   # resumed partial that was already full
                req.done = True
                self.batcher.finished.append(req)
                self.batcher.slots[slot] = None
            else:
                context = list(req.prompt) + list(req.generated)
                if len(context) + req.remaining > self.max_seq:
                    raise ValueError(
                        f"request {req.id}: context {len(context)} + remaining "
                        f"{req.remaining} > max_seq {self.max_seq}")
                logits = self._context_into_slot(slot, context)
                tok = int(self._pick_row(logits)[0, 0])
                req.generated.append(tok)
                self.n_emitted += 1
                self.positions[slot] = len(context)
                self.last_tok[slot, 0] = tok
                if not self.batcher._finish_if_done(slot, req, tok, self.eos_id):
                    return
            self.batcher._fill()
            req = self.batcher.slots[slot]

    def _context_into_slot(self, slot: int, context: List[int]) -> torch.Tensor:
        """Prefill ``context`` at batch 1, graft its KV into ``slot``;
        returns the last-position logits (1, Vpad)."""
        tok = torch.as_tensor([context], dtype=torch.int64, device=self.device)
        logits, pre = model_mod.prefill(self.params, {"tokens": tok}, self.cfg)
        self._slot_state.graft(pre, slot)
        self.prefill_tokens += len(context)
        return logits

    def _pick_row(self, logits: torch.Tensor) -> np.ndarray:
        gen = self._gen if self.temperature > 0 else None
        return _pick(logits, self.cfg.vocab_size, self.temperature, gen).cpu().numpy()

    def step(self) -> int:
        """One batched decode: every active slot advances one token; finished
        slots are refilled (and prefilled) without stopping the loop. Returns
        the number of tokens emitted."""
        active = self.batcher.active()
        if not active:
            return 0
        pos = np.minimum(self.positions, self.max_seq - 1)
        logits, _ = model_mod.decode_step(
            self.params, torch.as_tensor(self.last_tok, device=self.device),
            self.cache, torch.as_tensor(pos, device=self.device), self.cfg)
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
        for slot in filled:
            self._admit(slot)
        return len(active)

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
