"""Model configuration schema: the port's own copy of ``repro.models.config``
(no JAX in either), covering all assigned architecture families."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # dense-transformer knobs
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    qk_norm: bool = False           # Qwen3-style per-head RMSNorm on q/k
    use_bias: bool = False
    parallel_block: bool = False    # Cohere Command-R parallel attn+FFN
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    mrope: bool = False             # Qwen2-VL multimodal 3-axis RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w split of head_dim/2
    sliding_window: Optional[int] = None   # per-layer window (None = full)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # hybrid (RecurrentGemma / Griffin): block pattern within one scan group
    block_pattern: Tuple[str, ...] = ()    # e.g. ("rec", "rec", "attn")
    rglru_width: int = 0                   # recurrence width (= d_model here)
    conv_width: int = 4
    local_window: int = 2048               # local attention window

    # ssm (xLSTM): mLSTM/sLSTM pattern within one scan group
    xlstm_pattern: Tuple[str, ...] = ()    # e.g. ("m",)*7 + ("s",)
    xlstm_up_factor: float = 2.0

    # KV-cache quantization (dense family; §Perf capacity variant)
    kv_quant: bool = False       # int8 KV with per-token-per-head scales

    # encoder-decoder (Whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500                # 30 s of mel frames after conv stub

    # modality frontend stub (vlm / audio): inputs are embeddings, not tokens
    embeds_input: bool = False

    # end-of-sequence token id: terminates decode in the serving engine and
    # pads prompt batches (the pads are causally/length-masked inert)
    eos_id: int = 1

    dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.family == "ssm":
            blk = self._xlstm_block_params()
            return emb + L * blk
        if self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.is_moe:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        if self.family == "hybrid":
            # mix of recurrent + attention temporal blocks, each followed by MLP
            n_attn = sum(1 for b in self._hybrid_layers() if b == "attn")
            n_rec = L - n_attn
            rec = 3 * d * d + 2 * d  # gates + projections (approx)
            return emb + n_attn * (attn + mlp) + n_rec * (rec + mlp)
        return emb + L * (attn + mlp)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE uses top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        mlp = self.top_k * 3 * d * f + d * self.n_experts
        return emb + L * (attn + mlp)

    def _hybrid_layers(self) -> Tuple[str, ...]:
        pat = self.block_pattern or ("rec", "rec", "attn")
        out = []
        while len(out) < self.n_layers:
            out.extend(pat)
        return tuple(out[: self.n_layers])

    def _xlstm_block_params(self) -> int:
        d = self.d_model
        return int(8 * d * d * self.xlstm_up_factor)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def draft(self) -> "ModelConfig":
        """Tiny same-tokenizer sibling for speculative drafting (DESIGN.md
        §6.1-spec): shares ``vocab_size``/``eos_id`` (token ids must agree
        between draft and target) but shrinks every capacity knob, so k
        draft forwards cost a fraction of one target forward.  Dense-family
        layout so the draft runs the slot-decode path."""
        return self.replace(
            name=self.name + "-draft",
            family="dense",
            n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
            d_ff=256, head_dim=64,
            sliding_window=None, mrope=False, embeds_input=False,
            n_experts=0, top_k=0, kv_quant=False,
            qk_norm=False, use_bias=False, parallel_block=False)

    def smoke(self) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=max(2, len(self.block_pattern) or 2,
                         len(self.xlstm_pattern) or 2),
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=512 if self.d_ff else 0,
            head_dim=64,
            vocab_size=512,
        )
        if self.is_moe:
            kw.update(n_experts=4, top_k=min(self.top_k, 2))
        if self.mrope:
            # sections must sum to head_dim/2 (=32 in smoke variants)
            kw.update(mrope_sections=(8, 12, 12))
        if self.family == "audio":
            kw.update(n_encoder_layers=2, encoder_seq=64)
        if self.family == "hybrid":
            kw.update(n_layers=3, local_window=64,
                      rglru_width=min(self.rglru_width or 256, 256))
        if self.family == "ssm":
            kw.update(n_layers=len(self.xlstm_pattern) or 2)
        if self.sliding_window:
            kw.update(sliding_window=64)
        return self.replace(**kw)
