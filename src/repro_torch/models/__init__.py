from repro_torch.models.model import (
    cache_spec,
    cast_params,
    decode_step,
    init_cache,
    init_params,
    paged_decode_step,
    prefill,
)
from repro_torch.models.weights import params_from_numpy

__all__ = [
    "cache_spec",
    "cast_params",
    "decode_step",
    "init_cache",
    "init_params",
    "paged_decode_step",
    "params_from_numpy",
    "prefill",
]
