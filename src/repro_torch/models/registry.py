"""Family registry of the port: the uniform interface the engine calls.

Port of ``repro.models.registry`` for the dense family's paged serving
path.  The other families (moe, hybrid, ssm, audio, vlm) are ROADMAP
Queue A item 7; the slot ``decode_step`` waits for the ``flash_decode``
port (Queue B row 4) and ``paged_verify`` for ``spec_verify`` (row 3).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.models import dense
from repro_torch.models.config import ModelConfig


class Family(NamedTuple):
    init: Callable              # (cfg, generator, device, dtype) -> params
    prefill: Callable           # -> (last logits, contiguous cache)
    paged_decode: Callable      # (params, cfg, cache, token) -> logits, cache
    init_paged_pools: Callable
    prefill_to_pages: Callable


FAMILIES: Dict[str, Family] = {
    "dense": Family(dense.init, dense.prefill, dense.paged_decode_step,
                    dense.init_paged_pools, dense.prefill_to_pages),
}


def get_family(cfg: ModelConfig) -> Family:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A "
            f"item 7); ported: {sorted(FAMILIES)}")
    return FAMILIES[cfg.family]


def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str, dtype=None):
    return get_family(cfg).init(cfg, generator, device, dtype)
