"""repro_torch.core — the port's own copy of the host-only ``repro.core``
modules: the decentralized protocol (network, node, gossip, ledger, duel,
PoS routing, policy), and the ports of the reference's JAX modules of
section 5 on tensors: ``gametheory`` (the stake ODE, RK4) and
``creditsim`` (its Monte Carlo counterpart)."""

from repro_torch.core.duel import (DuelOutcome, DuelParams,
                                   expected_extra_requests, run_duel)
from repro_torch.core.gossip import (PeerRecord, PeerView, gossip_round,
                                     rounds_to_convergence)
from repro_torch.core.ledger import (BalanceView, CreditBlock, CreditChain,
                                     CreditOp, LedgerError, SharedLedger)
from repro_torch.core.network import _TREASURY, Network
from repro_torch.core.node import Node, QueuedRequest
from repro_torch.core.policy import NodePolicy
from repro_torch.core.pos import pos_sample, pos_sample_one, selection_probs

__all__ = [
    "DuelParams", "DuelOutcome", "expected_extra_requests", "run_duel",
    "PeerRecord", "PeerView", "gossip_round", "rounds_to_convergence",
    "BalanceView", "CreditBlock", "CreditChain", "CreditOp", "LedgerError",
    "SharedLedger", "Network", "_TREASURY", "Node", "QueuedRequest",
    "NodePolicy", "pos_sample", "pos_sample_one", "selection_probs",
]
