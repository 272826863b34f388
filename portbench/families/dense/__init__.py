"""The dense decoder family (the program's ``models/dense.py``), as
``portbench/families/__init__.py`` sets out."""

from portbench.families.dense.flops import DenseShape
from portbench.families.dense.model import ModelDims, dims
from portbench.families.dense.port import port_config
from portbench.families.dense.reference import served_logits
from portbench.families.dense.weights import make as make_weights

__all__ = ["DenseShape", "ModelDims", "dims", "flops", "make_weights",
           "port_config", "served_logits"]


def flops(m: ModelDims) -> DenseShape:
    return DenseShape(m.n_layers, m.d_model, m.n_heads, m.n_kv_heads,
                      m.head_dim, m.d_ff, m.vocab_size, m.gated_mlp)
