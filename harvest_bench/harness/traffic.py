"""The one traffic generator: request sizes and prompt tokens from a mix's
parameters and ``--seed``.

Every seed gets the same sizes in the same order: the seed draws the
tokens (and, elsewhere, the weights), not the work. A mix fixes a ``block``
of requests; each block holds the same ``block`` prompt lengths (the
distribution's quantiles at ``(i + 0.5) / block``, clipped and rounded) and
the same ``block`` output lengths, each list in an order of its own drawn
from the block's index. Prompt tokens are uniform over the vocabulary,
drawn for request ``i`` from ``(seed, i)`` alone, so a request's prompt
does not depend on when it was sent.

Why one order: in the closed loop (``loop.py``) the sequence of ``add()``
and ``step()`` calls, and so which admissions meet in one gap between two
steps, follows from the sizes and their order alone, not from how long any
call takes. The order is the work: drawn from the seed, it spread the
extraction cell's ``ttft_p90_ms`` by 16% over six seeds, where two runs of
one seed agreed within 0.3%. Fixed, a change to the program's speed moves
each request's time, never the sequence; only the close of the window,
which is on the clock, decides how far into it a run gets.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np


def quantile_sizes(dist: Dict, n: int) -> List[int]:
    """``n`` sizes at the quantiles ``(i + 0.5) / n`` of ``dist``
    (``{"dist": "lognormal", "median", "sigma", "min", "max"}``), clipped
    to ``[min, max]`` and rounded; ascending."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown size distribution {dist['dist']!r}; known: ('lognormal',)")
    z = statistics.NormalDist()
    mu, sigma = math.log(dist["median"]), dist["sigma"]
    out = []
    for i in range(n):
        x = math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return out


class Traffic:
    """Request ``i``'s (prompt tokens, output length) for one seed."""

    def __init__(self, mix: Dict, vocab_size: int, seed: int):
        self.mix = mix
        self.vocab_size = vocab_size
        self.seed = seed
        self.block = int(mix["block"])
        self.prompt_sizes = quantile_sizes(mix["prompt"], self.block)
        self.output_sizes = quantile_sizes(mix["output"], self.block)
        if mix["prompt"]["max"] + mix["output"]["max"] > mix["max_seq"]:
            raise ValueError(f"mix: the longest prompt and output exceed max_seq {mix['max_seq']}")
        self._orders: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _order(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        if b not in self._orders:
            rng = np.random.default_rng([b, 0])
            self._orders[b] = (rng.permutation(self.block), rng.permutation(self.block))
        return self._orders[b]

    def sizes(self, i: int) -> Tuple[int, int]:
        """(prompt length, output length) of request ``i``."""
        b, j = divmod(i, self.block)
        po, oo = self._order(b)
        return self.prompt_sizes[po[j]], self.output_sizes[oo[j]]

    def request(self, i: int) -> Tuple[List[int], int]:
        """(prompt tokens, output length) of request ``i``."""
        plen, out = self.sizes(i)
        rng = np.random.default_rng([self.seed, i, 1])
        return rng.integers(0, self.vocab_size, size=plen).tolist(), out
