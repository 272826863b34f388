"""Credit-based transaction system (paper §4.1, Table 1).

Each node keeps a local *Credit Block Chain*: hash-linked blocks of credit
operations (stake / unstake / reward / transfer / slash / mint), signed by the
proposer.  A block is *finalized* once a majority of peers validate it and
append it to their local chains (``network.py`` drives broadcast + votes).

Double-spending is impossible by construction: every validator replays the
operations against its own balance view and rejects blocks that would drive
any balance or stake negative; conflicting histories diverge at the hash chain
and are detectable immediately.

The paper (§C) also uses a *shared ledger* fast path at experiment scale; we
provide both (``SharedLedger`` has the same op API without chain overhead).
"""

from __future__ import annotations

import hashlib
import hmac
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

GENESIS_ID = "0" * 16

OP_KINDS = ("mint", "stake", "unstake", "transfer", "reward", "slash")


@dataclass(frozen=True)
class CreditOp:
    """One credit-related record inside a block."""

    kind: str            # one of OP_KINDS
    src: str             # paying / staking node ("" for mint)
    dst: str             # receiving node ("" for stake/unstake/slash)
    amount: float
    ref: str = ""        # request id / duel id this op settles

    def to_json(self) -> dict:
        return {"kind": self.kind, "src": self.src, "dst": self.dst,
                "amount": self.amount, "ref": self.ref}


@dataclass(frozen=True)
class CreditBlock:
    """Paper Table 1: Block ID, Parent ID, Timestamp, Operations, Proposer, Signature."""

    block_id: str
    parent_id: str
    timestamp: float
    operations: Tuple[CreditOp, ...]
    proposer: str
    signature: str

    @staticmethod
    def content_hash(parent_id: str, timestamp: float, ops: Sequence[CreditOp],
                     proposer: str) -> str:
        payload = json.dumps({
            "parent": parent_id, "ts": round(timestamp, 6),
            "ops": [o.to_json() for o in ops], "proposer": proposer,
        }, sort_keys=True).encode()
        return hashlib.sha256(payload).hexdigest()[:16]


def sign(secret: bytes, block_id: str) -> str:
    """HMAC-SHA256 stand-in for an ed25519 signature (see DESIGN.md §6.3)."""
    return hmac.new(secret, block_id.encode(), hashlib.sha256).hexdigest()[:16]


def verify_signature(secret: bytes, block: CreditBlock) -> bool:
    return hmac.compare_digest(sign(secret, block.block_id), block.signature)


class BalanceView:
    """Replayable balance + stake state machine shared by both ledgers."""

    def __init__(self) -> None:
        self.balance: Dict[str, float] = {}
        self.stake: Dict[str, float] = {}

    def copy(self) -> "BalanceView":
        v = BalanceView()
        v.balance = dict(self.balance)
        v.stake = dict(self.stake)
        return v

    def apply(self, op: CreditOp, check: bool = True) -> None:
        b, s = self.balance, self.stake
        if op.kind not in OP_KINDS:
            raise LedgerError(f"unknown op kind {op.kind!r}")
        if op.amount < 0:
            raise LedgerError("negative amount")
        if op.kind == "mint":
            b[op.dst] = b.get(op.dst, 0.0) + op.amount
        elif op.kind == "stake":
            if check and b.get(op.src, 0.0) < op.amount - 1e-9:
                raise LedgerError(f"{op.src} stakes {op.amount} > balance {b.get(op.src, 0.0)}")
            b[op.src] = b.get(op.src, 0.0) - op.amount
            s[op.src] = s.get(op.src, 0.0) + op.amount
        elif op.kind == "unstake":
            if check and s.get(op.src, 0.0) < op.amount - 1e-9:
                raise LedgerError(f"{op.src} unstakes {op.amount} > stake {s.get(op.src, 0.0)}")
            s[op.src] = s.get(op.src, 0.0) - op.amount
            b[op.src] = b.get(op.src, 0.0) + op.amount
        elif op.kind in ("transfer", "reward"):
            if check and b.get(op.src, 0.0) < op.amount - 1e-9:
                raise LedgerError(
                    f"double-spend: {op.src} pays {op.amount} > balance {b.get(op.src, 0.0)}")
            b[op.src] = b.get(op.src, 0.0) - op.amount
            b[op.dst] = b.get(op.dst, 0.0) + op.amount
        elif op.kind == "slash":
            # burn from stake (duel loser penalty)
            if check and s.get(op.src, 0.0) < op.amount - 1e-9:
                raise LedgerError(f"slash {op.amount} > stake {s.get(op.src, 0.0)}")
            s[op.src] = s.get(op.src, 0.0) - op.amount

    def total(self) -> float:
        return sum(self.balance.values()) + sum(self.stake.values())


class LedgerError(Exception):
    pass


class CreditChain:
    """A node's local credit block chain (full protocol path)."""

    def __init__(self, owner: str) -> None:
        self.owner = owner
        self.blocks: List[CreditBlock] = []
        self.view = BalanceView()
        self._ids = {GENESIS_ID}

    @property
    def head(self) -> str:
        return self.blocks[-1].block_id if self.blocks else GENESIS_ID

    def propose(self, ops: Sequence[CreditOp], timestamp: float,
                secret: bytes) -> CreditBlock:
        """Build + sign a block on the local head (does NOT append)."""
        ops = tuple(ops)
        bid = CreditBlock.content_hash(self.head, timestamp, ops, self.owner)
        return CreditBlock(block_id=bid, parent_id=self.head, timestamp=timestamp,
                           operations=ops, proposer=self.owner,
                           signature=sign(secret, bid))

    def validate(self, block: CreditBlock, proposer_secret: Optional[bytes] = None
                 ) -> Tuple[bool, str]:
        """Independent peer validation (paper: 'independently validate')."""
        if block.parent_id != self.head:
            return False, f"parent {block.parent_id} != head {self.head}"
        expect = CreditBlock.content_hash(block.parent_id, block.timestamp,
                                          block.operations, block.proposer)
        if expect != block.block_id:
            return False, "tampered content (hash mismatch)"
        if proposer_secret is not None and not verify_signature(proposer_secret, block):
            return False, "bad signature"
        trial = self.view.copy()
        try:
            for op in block.operations:
                trial.apply(op)
        except LedgerError as e:
            return False, str(e)
        return True, "ok"

    def append(self, block: CreditBlock) -> None:
        ok, why = self.validate(block)
        if not ok:
            raise LedgerError(f"append rejected: {why}")
        for op in block.operations:
            self.view.apply(op)
        self.blocks.append(block)
        self._ids.add(block.block_id)

    def verify_chain(self) -> bool:
        """Full-chain audit: hash links + replay from genesis."""
        parent = GENESIS_ID
        replay = BalanceView()
        for blk in self.blocks:
            if blk.parent_id != parent:
                return False
            if CreditBlock.content_hash(blk.parent_id, blk.timestamp,
                                        blk.operations, blk.proposer) != blk.block_id:
                return False
            try:
                for op in blk.operations:
                    replay.apply(op)
            except LedgerError:
                return False
            parent = blk.block_id
        return (replay.balance == self.view.balance and replay.stake == self.view.stake)

    # convenience accessors -------------------------------------------------
    def balance_of(self, node: str) -> float:
        return self.view.balance.get(node, 0.0)

    def stake_of(self, node: str) -> float:
        return self.view.stake.get(node, 0.0)

    def stakes(self) -> Dict[str, float]:
        return dict(self.view.stake)


class SharedLedger:
    """Paper §C fast path: one shared balance view, same op API."""

    def __init__(self) -> None:
        self.view = BalanceView()
        self.history: List[CreditOp] = []

    def apply(self, ops: Iterable[CreditOp]) -> None:
        ops = list(ops)
        trial = self.view.copy()
        for op in ops:                 # atomic: all-or-nothing
            trial.apply(op)
        for op in ops:
            self.view.apply(op)
        self.history.extend(ops)

    def balance_of(self, node: str) -> float:
        return self.view.balance.get(node, 0.0)

    def stake_of(self, node: str) -> float:
        return self.view.stake.get(node, 0.0)

    def stakes(self) -> Dict[str, float]:
        return dict(self.view.stake)
