"""A dense decoder's model FLOPs, from its widths: a frozen copy of the
serving smoke script's model-FLOP count.  Nothing here imports the
program."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DenseShape:
    """The widths that set a dense decoder's FLOPs."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    gated_mlp: bool       # SwiGLU: three MLP matrices, else two

    @property
    def layer_matmul_params(self) -> int:
        d, qd, kvd = self.d_model, self.n_heads * self.head_dim, \
            self.n_kv_heads * self.head_dim
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        return d * (qd + 2 * kvd) + qd * d + mlp

    def attention_flops(self, context: int) -> float:
        """QK and PV of one query over ``context`` keys, every layer."""
        return 4.0 * self.n_layers * self.n_heads * self.head_dim * context

    def prefill_flops(self, prompt: int) -> float:
        """Model FLOPs of one prompt: every position through every layer's
        matrices, the causal attention, and the head at the last position."""
        mm = 2.0 * prompt * self.n_layers * self.layer_matmul_params
        attn = (4.0 * self.n_layers * self.n_heads * self.head_dim
                * prompt * (prompt + 1) / 2)
        return mm + attn + 2.0 * self.d_model * self.vocab

    def decode_flops(self, context: int) -> float:
        """Model FLOPs of one decoded token that attends ``context`` keys
        (itself included): the layers' matrices, attention, the head."""
        return (2.0 * self.n_layers * self.layer_matmul_params
                + self.attention_flops(context)
                + 2.0 * self.d_model * self.vocab)
