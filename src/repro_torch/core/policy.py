"""User-level policy framework (paper §4.3, §7.2).

Each provider independently configures when it offloads its own queue, when it
accepts delegated work, how much it stakes, and whether its own users get
priority.  System-level policies (PoS routing, ledger, gossip, duel-and-judge)
are implemented in their respective modules and are not provider-tunable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class NodePolicy:
    """Paper defaults (Appendix C): offload 80%, accept 80%, target util 70%."""

    stake: float = 10.0              # initial stake amount
    offload_freq: float = 0.8        # prob. of offloading an eligible request
    accept_freq: float = 0.8         # prob. of accepting a delegated request
    target_utilization: float = 0.7  # accept delegated work only below this
    offload_queue_threshold: int = 4 # offload if local queue exceeds this ...
    offload_util_threshold: float = 1.2  # ... or utilization passes the knee
    prioritize_local: bool = True    # own users served before delegated work
    max_delegated_queue: int = 64    # hard cap on queued delegated requests
    offload_price: float = 1.0       # credits paid per delegated request

    def wants_offload(self, queue_len: int, n_active: int, saturation: int,
                      balance: float, rng: np.random.Generator) -> bool:
        """Should this node try to delegate one of its queued requests?"""
        overloaded = (queue_len > self.offload_queue_threshold
                      or n_active / max(1, saturation) >= self.offload_util_threshold)
        can_pay = balance >= self.offload_price
        return overloaded and can_pay and rng.random() < self.offload_freq

    def accepts_delegated(self, n_active: int, saturation: int,
                          delegated_queue: int, rng: np.random.Generator) -> bool:
        """Probe response: is this node willing to take remote work now?"""
        util = n_active / max(1, saturation)
        if util >= self.target_utilization:
            return False
        if delegated_queue >= self.max_delegated_queue:
            return False
        return rng.random() < self.accept_freq
