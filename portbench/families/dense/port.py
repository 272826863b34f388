"""The program's ``ModelConfig`` for a dense configuration file: the one
place of this family that touches the program."""

from __future__ import annotations

from typing import Dict

from portbench.families.dense.model import ModelDims

# the fields held equal to the program's registered architecture
_HELD = ("family", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
         "head_dim", "norm_type", "act", "use_bias", "parallel_block",
         "tie_embeddings", "rope_theta", "qk_norm", "sliding_window",
         "eos_id", "mrope", "n_experts")


def port_config(cfg: Dict, m: ModelDims, dtype: str):
    """The program's ``ModelConfig``, held to its registered architecture
    (``deployment.port_arch``) in every field but the depth."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig
    mc = ModelConfig(
        name=cfg["name"], family="dense", n_layers=m.n_layers,
        d_model=m.d_model, n_heads=m.n_heads, n_kv_heads=m.n_kv_heads,
        d_ff=m.d_ff, vocab_size=m.vocab_size, head_dim=m.head_dim,
        norm_type=m.norm, act="swiglu" if m.gated_mlp else "gelu",
        use_bias=m.use_bias, parallel_block=m.parallel_block,
        tie_embeddings=m.tie_embeddings, rope_theta=m.rope_theta,
        eos_id=m.eos_id, dtype=dtype)
    arch = cfg["deployment"].get("port_arch")
    if arch:
        base = get_config(arch)
        diff = {f: (getattr(base, f), getattr(mc, f)) for f in _HELD
                if getattr(base, f) != getattr(mc, f)}
        if diff:
            raise ValueError(f"{cfg['name']}: differs from the port's "
                             f"{arch} in {diff}")
    return mc
