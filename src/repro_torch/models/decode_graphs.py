"""Piecewise CUDA graphs of the batched one-token decode.

A decode step launches over a hundred small kernels a layer; replayed from
a CUDA graph, a stretch of them costs the host one launch. The step is cut
at each MoE layer's feed-forward (``model.decode_pieces``): the pieces
between (the embedding, each layer's norms and attention with its cache
write, the final norm and the head) are captured, and the MoE layers run
eagerly in between, as they do without graphs, with their spans and
launch counts. A piece reads static inputs: the token and position
buffers, the output of the piece before it, and one buffer that each MoE
layer's output is copied into; it writes the live cache in place, at the
addresses it was captured with. The kernels, shapes and order are those of
the eager step, so the logits and the cache are the same bits.

:func:`graphable` says where the pieces can be captured: on a CUDA device,
with no tensor-parallel group (a gloo collective cannot be captured), over
dense and moe segments only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import tp_size
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.model import decode_pieces, run_pieces


def graphable(cfg: ModelConfig, device: torch.device, tp=None) -> bool:
    """Whether :class:`DecodeGraphs` can capture ``cfg``'s decode on
    ``device`` under ``tp``."""
    return (torch.device(device).type == "cuda" and tp_size(tp) == 1
            and all(s.kind in ("dense", "moe") for s in transformer.segments_for(cfg)))


class DecodeGraphs:
    """The decode of ``batch`` rows over ``cache``, captured at the first
    :meth:`step` and replayed at every later one. Copy the step's tokens
    and positions in with :meth:`load` first. ``params`` and ``cache`` are
    held by address: whoever replaces either makes a new instance."""

    def __init__(self, params, cache, cfg: ModelConfig, batch: int, device: torch.device):
        self.token = torch.zeros((batch, 1), dtype=torch.int64, device=device)
        self.pos = torch.zeros((batch,), dtype=torch.int64, device=device)
        self._pieces, self._moes = decode_pieces(params, cache, self.pos, cfg)
        self._h = torch.zeros((batch, 1, cfg.d_model), dtype=cfg.compute_dtype, device=device)
        self._graphs = self._outs = self._launches = None
        self.failed: Optional[str] = None   # why a capture failed

    def load(self, token: np.ndarray, pos: np.ndarray) -> None:
        self.token.copy_(torch.from_numpy(token))
        self.pos.copy_(torch.from_numpy(pos))

    def step(self) -> torch.Tensor:
        """The (batch, Vpad) fp32 logits of the loaded step; after the
        first, a view of a static tensor that the next step overwrites. The
        first step runs eagerly and then captures; where a piece cannot be
        captured, :attr:`failed` says why and nothing is replayed."""
        with spans.span("model.decode_step"):
            if self._graphs is None:
                spans.count(graphed=0)
                return self._capture()
            spans.count(graphed=1)
            graphs, outs = self._graphs, self._outs
            graphs[0].replay()
            for moe, out, graph in zip(self._moes, outs, graphs[1:]):
                self._h.copy_(moe(out[1]))
                graph.replay()
            ops.add_launches(self._launches)
            return outs[-1][0]

    def _capture(self) -> torch.Tensor:
        """Run the step eagerly on a side stream (the capture's warm-up,
        its launches counted), then capture every piece into one memory
        pool, none of the capture's launches counted."""
        dev = self.token.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            logits = run_pieces(self._pieces, self._moes, self.token)
        side.synchronize()
        before = ops.launch_state()
        pool = torch.cuda.graph_pool_handle()
        graphs, outs = [], []
        args = (self.token,)
        try:
            with torch.cuda.stream(side):
                for piece in self._pieces:
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=pool)
                    try:
                        outs.append(piece(*args))
                    finally:
                        graph.capture_end()
                    graphs.append(graph)
                    args = (outs[-1][0], self._h)
            self._graphs, self._outs = graphs, outs
        except RuntimeError as e:   # a piece waited for the device, say
            self.failed = f"{type(e).__name__}: {e}"
        finally:
            torch.cuda.current_stream(dev).wait_stream(side)
            after = ops.launch_state()
            ops.add_launches({k: before[k] - n for k, n in after.items()})
        self._launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
        return logits
