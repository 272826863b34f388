"""A configuration file of ``portbench/configs/`` read into the widths the
benchmark needs, with nothing of the program.

A configuration file holds the published ``config.json`` keys at its top
level, as published except for the keys that ``reduced`` lists (cuts of
depth).  Where the program runs a published key otherwise, the file says
so under ``port_departures``: that key's value as run (``run``) and why.
Beside them: a ``layout`` of the block's switches that the published model
type implies, ``assumed`` for what the source does not give, and the
``deployment``.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass
from typing import Any, Dict


@dataclass(frozen=True)
class ModelDims:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str                  # layernorm | rmsnorm
    norm_eps: float
    gated_mlp: bool            # SwiGLU, else GeLU (tanh)
    parallel_block: bool       # attention and MLP beside each other
    use_bias: bool
    tie_embeddings: bool
    rope_theta: float
    eos_id: int
    logit_scale: float = 1.0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def kv_bytes_per_token(self) -> int:
        return 2 * self.n_layers * self.kv_dim * 2


def load(path: pathlib.Path) -> Dict:
    return json.loads(pathlib.Path(path).read_text())


def as_run(cfg: Dict, key: str, default: Any = None) -> Any:
    """``key`` as the program runs it: its ``port_departures`` value where
    the file lists one, else the published value."""
    dep = cfg.get("port_departures", {})
    if key in dep:
        return dep[key]["run"]
    return cfg.get(key, default)


def dims(cfg: Dict) -> ModelDims:
    if as_run(cfg, "use_qk_norm", False):
        raise ValueError(f"{cfg['name']}: the dense family runs no q/k norm")
    lay = cfg["layout"]
    heads = cfg["num_attention_heads"]
    return ModelDims(
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim", cfg["hidden_size"] // heads),
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        norm=lay["norm"], norm_eps=lay["norm_eps"],
        gated_mlp=lay["gated_mlp"], parallel_block=lay["parallel_block"],
        use_bias=lay["use_bias"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(as_run(cfg, "rope_theta")),
        eos_id=int(as_run(cfg, "eos_token_id")),
        logit_scale=float(as_run(cfg, "logit_scale", 1.0)))
