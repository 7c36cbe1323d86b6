"""How ``correct`` is decided: the served tokens of a sample of the
requests the window finished, held against the plain reference.

The sample is drawn from the seed: the request with the most served tokens
and the one with the longest context, then others in an order drawn from
the seed until ``served_tokens`` are in it. The reference runs once over
each request's prompt and served tokens (the last one left out, which no
position predicts), and gives the logits at every position that served a
token: the prompt's last (the admission's token) and each decoded one's.

``gap`` of a served token is the reference's best logit there less the
reference's logit of the token served. ``gap_max`` is the widest over the
sample; a sound program reads above zero only where it split a near tie.
The control puts a lower precision in the program's place: at the same
positions it reads the gap of the token that it ranks first.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def sample(finished: Sequence, seed: int, served_tokens: int) -> List:
    """The requests to compare (each has ``.prompt`` and ``.generated``)."""
    reqs = sorted(finished, key=lambda r: r.id)
    if not reqs:
        return []
    chosen = {max(reqs, key=lambda r: (len(r.generated), r.id)).id,
              max(reqs, key=lambda r: (len(r.prompt) + len(r.generated), r.id)).id}
    by_id = {r.id: r for r in reqs}
    total = sum(len(by_id[i].generated) for i in chosen)
    for j in np.random.default_rng([seed, 2]).permutation(len(reqs)):
        if total >= served_tokens:
            break
        r = reqs[j]
        if r.id not in chosen:
            chosen.add(r.id)
            total += len(r.generated)
    return [by_id[i] for i in sorted(chosen)]


def reference_module(config: Dict):
    return importlib.import_module(f"harvest_bench.reference.{config['reference']}")


def hyperparameters(config: Dict, rehearsal: bool) -> Dict:
    return config["rehearsal"]["hp"] if rehearsal else config


def reference_logits(weights, config: Dict, reqs: List, prec, rehearsal: bool,
                     group: int = 8) -> List[torch.Tensor]:
    """Each request's reference logits at its served positions, the
    requests in groups of ``group`` through the stack together."""
    ref = reference_module(config)
    hp = hyperparameters(config, rehearsal)
    out: List[torch.Tensor] = []
    with torch.no_grad():
        for lo in range(0, len(reqs), group):
            part = reqs[lo:lo + group]
            seqs = [list(r.prompt) + list(r.generated[:-1]) for r in part]
            out += ref.logits(weights, hp, seqs, [len(r.generated) for r in part], prec)
    return out


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit less its logit of ``tokens``."""
    return ref.max(dim=-1).values - ref.gather(-1, tokens[:, None].to(ref.device))[:, 0]


def gap_stats(gap: torch.Tensor, prefix: str = "") -> Dict[str, float]:
    """The widest gap, the mean gap and the share of positions whose gap is
    above zero (where the token differs from the reference's best)."""
    return {f"{prefix}gap_max": float(gap.max()), f"{prefix}gap_mean": float(gap.mean()),
            f"{prefix}flip_share": float((gap > 0).float().mean())}


def compare(weights, config: Dict, finished: Sequence, seed: int, served_tokens: int,
            rehearsal: bool, control: Optional[object] = None) -> Dict[str, float]:
    """The numbers compared (``gap_stats`` of the program's served tokens)
    and, with ``control`` (a precision object), the same of the tokens it
    ranks first, prefixed ``control_``; ``sampled`` and ``served_tokens``
    say what the sample held."""
    from harvest_bench.reference.common import Exact, no_tf32
    no_tf32()
    reqs = sample(finished, seed, served_tokens)
    ref = reference_logits(weights, config, reqs, Exact(), rehearsal)
    served = torch.cat([gaps(lg, torch.as_tensor(r.generated)) for lg, r in zip(ref, reqs)])
    out = {**gap_stats(served), "sampled": len(reqs), "served_tokens": int(served.numel())}
    if control is not None:
        ctrl = reference_logits(weights, config, reqs, control, rehearsal)
        out.update(gap_stats(torch.cat([gaps(lg, cl.argmax(dim=-1))
                                        for lg, cl in zip(ref, ctrl)]), "control_"))
    return out
