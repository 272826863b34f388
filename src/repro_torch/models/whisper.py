"""Whisper-style encoder-decoder (arXiv:2212.04356) on tensors.

Port of ``repro.models.whisper``.  The mel-spectrogram and conv frontend
is a stub in the reference too: a batch carries precomputed frame
embeddings ``encoder_embeds`` (B, encoder_seq, d) beside the decoder's
``tokens``.  Learned positional tables, LayerNorm, GeLU MLPs, biased
projections (``wk`` has none, as in the reference), and the lm head tied
to the token embedding.

Attention goes through ``kernels.ops``: the encoder's self attention is
the prefill kernel without a causal mask; the decoder's self attention in
``apply`` and ``prefill`` is causal; its cross attention over the encoder
output is the prefill kernel without a mask at ``Sq != Skv``.  At decode,
the self attention writes the step's K/V into a ring of ``cap`` positions
(slot ``length % cap``) and attends ``min(length + 1, cap)`` of them, and
the cross attention attends every encoder position, both through the
contiguous decode kernel with the scalar length broadcast to (B,).

Layouts are the reference's: weights ``(d_in, d_out)``; the encoder's
``enc_attn``/``enc_mlp`` and the decoder's ``dec_self``/``dec_cross``/
``dec_mlp`` stacked on a leading layer axis; the decode cache ``{"k",
"v": (L, B, cap, Hkv, dh), "cross_k", "cross_v": (L, B, encoder_seq,
Hkv, dh), "length": ()}``.  Unlike the reference, ``decode_step`` writes
the self-attention rings in place.

Under a mesh the params, batch and cache may be DTensors sharded by
``launch.sharding``: the reference's five ``cm.shard`` sites sit at the
same places (the encoder's input and each layer's output, the
decoder's input and each layer's output, the logits), each output
projection's partial sums over ``model`` are summed before its bias and
the residual (as ``dense`` does), the weights are FSDP-gathered on use,
the token embeddings looked up on each rank's rows and the positional
tables (columns over ``model``) on each rank's columns (``_pos_rows``),
the tied head gathered as ``dense.logits_of`` gathers it, and the ring
written shard by shard (``dense._write_slots``).  The cross cache,
sequence-sharded over ``model``, reaches the decode kernel on each
rank's batch rows and heads (``kernels.ops``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import _index, _ring_step

_MAX_TARGET_POS = 4096   # learned decoder positions (real Whisper: 448)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str, dtype: Optional[torch.dtype] = None
         ) -> Dict:
    """Random weights with the reference's distributions (normal
    ``1/sqrt(d_in)`` projections, zero biases, unit LayerNorm scales and
    zero LayerNorm biases, normal 0.01 positional tables, normal 0.02
    embeddings), drawn from ``generator`` on ``device`` in ``dtype``
    (default ``cfg.dtype``)."""
    dt = dtype or _dt(cfg)
    d, f = cfg.d_model, cfg.d_ff

    def proj(lead, d_in, d_out):
        return cm.dense_init(generator, lead + (d_in, d_out), dt, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn(n):
        lead = (n,)
        return {"ln": cm.norm_params(lead + (d,), "layernorm", dt, device),
                "wq": proj(lead, d, cfg.q_dim), "bq": zeros(n, cfg.q_dim),
                "wk": proj(lead, d, cfg.kv_dim),
                "wv": proj(lead, d, cfg.kv_dim), "bv": zeros(n, cfg.kv_dim),
                "wo": proj(lead, cfg.q_dim, d), "bo": zeros(n, d)}

    def mlp(n):
        lead = (n,)
        return {"ln": cm.norm_params(lead + (d,), "layernorm", dt, device),
                "w_up": proj(lead, d, f), "b_up": zeros(n, f),
                "w_down": proj(lead, f, d), "b_down": zeros(n, d)}

    def positions(n):
        return torch.empty((n, d), dtype=dt, device=device).normal_(
            0.0, 0.01, generator=generator)

    le, ld = cfg.n_encoder_layers, cfg.n_layers
    return {
        "enc_pos": positions(cfg.encoder_seq),
        "enc_attn": attn(le), "enc_mlp": mlp(le),
        "enc_norm": cm.norm_params((d,), "layernorm", dt, device),
        "embed": cm.embed_init(generator, cfg.padded_vocab, d, dt, device),
        "dec_pos": positions(_MAX_TARGET_POS),
        "dec_self": attn(ld), "dec_cross": attn(ld), "dec_mlp": mlp(ld),
        "dec_norm": cm.norm_params((d,), "layernorm", dt, device),
    }   # the lm head is the token embedding, tied (as in Whisper)


def _ln(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return cm.apply_norm(x, p, "layernorm")


def _heads(cfg: ModelConfig, x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], n, cfg.head_dim)


def _attn_proj(ap: Dict, cfg: ModelConfig, hq: torch.Tensor,
               hkv: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, Sq, H, dh) from ``hq``, k and v (B, Skv, Hkv, dh) from
    ``hkv``; q and v biased, k not."""
    q = _heads(cfg, hq @ ap["wq"] + ap["bq"], cfg.n_heads)
    k = _heads(cfg, hkv @ ap["wk"], cfg.n_kv_heads)
    v = _heads(cfg, hkv @ ap["wv"] + ap["bv"], cfg.n_kv_heads)
    return q, k, v


def _sum(x: torch.Tensor) -> torch.Tensor:
    """An output projection's partial sums over ``model`` summed, where
    the reference's GSPMD sums them (a plain tensor as it is)."""
    return cm.shard(x, "batch", "seq", None)


def _out(ap: Dict, cfg: ModelConfig, x: torch.Tensor,
         a: torch.Tensor) -> torch.Tensor:
    """x plus the attention output ``a`` (B, S, H, dh) projected back."""
    return x + _sum(a.reshape(*x.shape[:2], cfg.q_dim) @ ap["wo"]) \
        + ap["bo"]


def _pos_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a positional table (n, d).  A DTensor table, its
    columns over ``model``, is indexed on each rank's own columns: the
    rows of a table whose dim 0 is whole, and the result keeps the
    table's placements."""
    if not isinstance(table, DTensor):
        return table[idx]
    if isinstance(idx, DTensor):
        idx = idx.full_tensor()
    return DTensor.from_local(table.to_local()[idx], table.device_mesh,
                              table.placements, run_check=False)


def encode(params: Dict, cfg: ModelConfig,
           embeds: torch.Tensor) -> torch.Tensor:
    """embeds: (B, Se, d) frame embeddings from the (stub) frontend ->
    the encoder output (B, Se, d), bidirectional attention through the
    prefill kernel."""
    s = embeds.shape[1]
    x = embeds.to(_dt(cfg)) + _pos_rows(
        params["enc_pos"], torch.arange(s, device=embeds.device))[None]
    x = cm.shard(x, "batch", "seq", None)
    for l in range(cfg.n_encoder_layers):
        ap = cm.used(_index(params["enc_attn"], l))
        h = _ln(x, ap["ln"])
        q, k, v = _attn_proj(ap, cfg, h, h)
        x = _out(ap, cfg, x, ops.attention(q, k, v, causal=False))
        mp = cm.used(_index(params["enc_mlp"], l))
        h2 = _ln(x, mp["ln"])
        x = x + (_sum(cm.gelu(h2 @ mp["w_up"] + mp["b_up"]) @ mp["w_down"])
                 + mp["b_down"])
        x = cm.shard(x, "batch", "seq", None)
    return _ln(x, params["enc_norm"])


def _mlp(mp: Dict, x: torch.Tensor) -> torch.Tensor:
    """The decoder's GeLU MLP with its residual."""
    h = _ln(x, mp["ln"])
    return x + _sum(cm.gelu(h @ mp["w_up"] + mp["b_up"]) @ mp["w_down"]) \
        + mp["b_down"]


def _decoder(params: Dict, cfg: ModelConfig, batch: Dict
             ) -> Tuple[torch.Tensor, list]:
    """Encode ``batch["encoder_embeds"]`` and run the decoder over
    ``batch["tokens"]`` (B, S): causal self attention, then cross
    attention over the encoder output.  Returns (the hidden states after
    the final norm, each layer's (self K, self V, cross K, cross V))."""
    enc_out = encode(params, cfg, batch["encoder_embeds"])
    tokens = batch["tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device) \
        % _MAX_TARGET_POS
    x = cm.shard(cm.embed_rows(params["embed"], tokens)
                 + _pos_rows(params["dec_pos"], pos)[None], "batch", "seq",
                 None)
    kvs = []
    for l in range(cfg.n_layers):
        sp = cm.used(_index(params["dec_self"], l))
        cp = cm.used(_index(params["dec_cross"], l))
        h = _ln(x, sp["ln"])
        q, k, v = _attn_proj(sp, cfg, h, h)
        x = _out(sp, cfg, x, ops.attention(q, k, v, causal=True))
        h = _ln(x, cp["ln"])
        qc, kc, vc = _attn_proj(cp, cfg, h, enc_out)
        x = _out(cp, cfg, x, ops.attention(qc, kc, vc, causal=False))
        x = cm.shard(_mlp(cm.used(_index(params["dec_mlp"], l)), x), "batch",
                     "seq", None)
        kvs.append((k, v, kc, vc))
    return _ln(x, params["dec_norm"]), kvs


def apply(params: Dict, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """batch: {"encoder_embeds": (B, Se, d), "tokens": (B, S)} -> logits
    (B, S, padded_vocab) at every decoder position."""
    return dense.logits_of(params, cfg, _decoder(params, cfg, batch)[0])


def prefill(params: Dict, cfg: ModelConfig, inputs, *,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Encode the audio and run the decoder prompt (a batch dict with
    ``encoder_embeds`` and ``tokens``; tokens alone, as the engine's wave
    path passes them, raise ``KeyError('encoder_embeds')``, as in the
    reference).  Returns the last position's logits (B, 1, padded_vocab)
    and the cache: the self K/V zero-padded to ``cap = max(S, capacity)``
    positions, the cross K/V of every encoder position, "length": S."""
    batch = dense._as_batch(inputs)
    x, kvs = _decoder(params, cfg, batch)
    s = batch["tokens"].shape[1]
    cap = max(s, capacity or s)

    def stacked(j, pad=0):
        # (L, B, S, Hkv, dh), padded only where it needs to be: DTensor's
        # pad rule fails on a zero pad in torch 2.11
        a = torch.stack([kv[j] for kv in kvs])
        return F.pad(a, (0, 0, 0, 0, 0, pad)) if pad else a

    cache = {"k": stacked(0, cap - s), "v": stacked(1, cap - s),
             "cross_k": stacked(2), "cross_v": stacked(3),
             "length": torch.tensor(s, dtype=torch.int32, device=x.device)}
    return dense.logits_of(params, cfg, x[:, -1:]), cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One lock-step decode step: token (B, 1) at the cache's scalar
    length.  The self attention writes slot ``length % cap`` of each
    layer's ring in place and attends ``min(length + 1, cap)`` positions;
    the cross attention attends all encoder positions.  Returns (logits
    (B, 1, padded_vocab), the cache with length + 1)."""
    length = cache["length"]
    b = token.shape[0]
    _, slot, n_valid = _ring_step(length, b, cache["k"].shape[2])
    n_cross = torch.full((b,), cache["cross_k"].shape[2], dtype=torch.int32,
                         device=token.device)
    x = (cm.embed_rows(params["embed"], token)
         + _pos_rows(params["dec_pos"], (length.long() % _MAX_TARGET_POS
                                         ).reshape(1))[None])
    for l in range(cfg.n_layers):
        sp = cm.used(_index(params["dec_self"], l))
        cp = cm.used(_index(params["dec_cross"], l))
        kc, vc = cache["k"][l], cache["v"][l]
        h = _ln(x, sp["ln"])
        q, k, v = _attn_proj(sp, cfg, h, h)
        dense._write_slots(kc, slot, k)
        dense._write_slots(vc, slot, v)
        x = _out(sp, cfg, x, ops.decode(q, kc, vc, n_valid))
        h = _ln(x, cp["ln"])
        q = _heads(cfg, h @ cp["wq"] + cp["bq"], cfg.n_heads)
        x = _out(cp, cfg, x, ops.decode(q, cache["cross_k"][l],
                                        cache["cross_v"][l], n_cross))
        x = _mlp(cm.used(_index(params["dec_mlp"], l)), x)
    x = _ln(x, params["dec_norm"])
    return dense.logits_of(params, cfg, x), {**cache, "length": length + 1}
