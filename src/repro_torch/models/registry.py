"""Family registry of the port: the uniform interface the engine calls.

Port of ``repro.models.registry`` for every family of the reference: the
dense and vlm families (one module: the full-sequence forward, slot
decode, paged decode and the speculative paged verify), the moe family
(the full-sequence forward with its aux loss, and the lock-step decode
the engine's wave path runs), and the hybrid (RG-LRU and local
attention), ssm (xLSTM) and audio (Whisper's encoder-decoder) families,
each with the full-sequence forward and the lock-step decode only.
``apply_logits`` drops the aux loss, ``apply_with_aux`` keeps it (zero
for a family without one).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import dense, moe, rglru, whisper, xlstm
from repro_torch.models.config import ModelConfig


class Family(NamedTuple):
    init: Callable              # (cfg, generator, device, dtype) -> params
    apply: Callable             # (params, cfg, batch) -> (B, S, V) logits
    prefill: Callable           # -> (last logits, contiguous cache)
    decode_step: Callable       # (params, cfg, cache, token) -> logits, cache
    has_aux: bool = False       # apply returns (logits, aux loss)
    slot_decode: bool = False   # per-row cache lengths + prefill
                                # last_positions (slot continuous batching)
    # paged-KV capability: set together or not at all
    paged_decode: Optional[Callable] = None
    init_paged_pools: Optional[Callable] = None
    prefill_to_pages: Optional[Callable] = None
    # speculative verify of K tokens against the pools (needs paged)
    paged_verify: Optional[Callable] = None
    # (params, cfg, pools, batch) -> the paged decode step's captured
    # graphs, or None where it stays eager (needs paged)
    paged_decode_graphs: Optional[Callable] = None


FAMILIES: Dict[str, Family] = {
    "dense": Family(dense.init, dense.apply, dense.prefill,
                    dense.decode_step,
                    slot_decode=True, paged_decode=dense.paged_decode_step,
                    init_paged_pools=dense.init_paged_pools,
                    prefill_to_pages=dense.prefill_to_pages,
                    paged_verify=dense.paged_verify_step,
                    paged_decode_graphs=dense.paged_decode_graphs),
    "vlm": Family(dense.init, dense.apply, dense.prefill,
                  dense.decode_step,
                  slot_decode=True, paged_decode=dense.paged_decode_step,
                  init_paged_pools=dense.init_paged_pools,
                  prefill_to_pages=dense.prefill_to_pages,
                  paged_verify=dense.paged_verify_step,
                  paged_decode_graphs=dense.paged_decode_graphs),
    "moe": Family(moe.init, moe.apply, moe.prefill, moe.decode_step,
                  has_aux=True),
    "hybrid": Family(rglru.init, rglru.apply, rglru.prefill,
                     rglru.decode_step),
    "ssm": Family(xlstm.init, xlstm.apply, xlstm.prefill, xlstm.decode_step),
    "audio": Family(whisper.init, whisper.apply, whisper.prefill,
                    whisper.decode_step),
}


def get_family(cfg: ModelConfig) -> Family:
    return FAMILIES[cfg.family]


def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str, dtype=None):
    return get_family(cfg).init(cfg, generator, device, dtype)


def apply_logits(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Full-sequence forward returning the logits at every position of
    the batch (an aux loss is dropped)."""
    fam = get_family(cfg)
    out = fam.apply(params, cfg, batch)
    return out[0] if fam.has_aux else out


def apply_with_aux(params, cfg: ModelConfig, batch: Dict, **kw
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward returning (logits, aux loss); a family without
    an aux loss returns a float32 zero.  ``kw`` goes to the family's
    ``apply`` (xlstm's ``chunk``)."""
    fam = get_family(cfg)
    out = fam.apply(params, cfg, batch, **kw)
    if fam.has_aux:
        return out
    return out, torch.zeros((), dtype=torch.float32, device=out.device)
