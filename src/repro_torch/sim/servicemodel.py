"""Analytic node service model: hardware x model x backend -> tokens/s.

The paper's Fig 4/5/7/8 numbers are dominated by queueing delay, not kernel
micro-performance, so we model a node's backend as a concurrency-limited
server whose per-request service time is::

    T(req) = prompt / prefill_tps + output / decode_tps(batch)

with decode throughput shared beyond a saturation knee (continuous batching:
per-stream decode speed is ~flat until the batch saturates compute/HBM, then
degrades ~linearly).  Calibration constants below are order-of-magnitude
figures from public vLLM/SGLang benchmarks for the paper's hardware.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# rough per-(GPU) capability scalars (A100 = 1.0 reference)
_GPU_SCALE: Dict[str, float] = {
    "A100": 1.00, "4xA100": 3.40, "L40S": 0.62, "ADA6000": 0.60,
    "RTX4090": 0.55, "RTX3090": 0.30,
}
# serving backend efficiency (paper Fig 6c: FlashInfer > Triton >> SDPA)
_BACKEND_SCALE: Dict[str, float] = {
    "sglang": 1.00, "vllm": 0.95,
    "flashinfer": 1.00, "triton": 0.98, "sdpa": 0.55,
}
# model-size scalar: tokens/s ~ 1/params (memory-bound decode)
_MODEL_PARAMS_B: Dict[str, float] = {
    "qwen3-32b": 32.8, "qwen3-8b": 8.2, "qwen3-4b": 4.0, "qwen3-0.6b": 0.6,
    "llama3.1-8b": 8.0, "deepseek-qwen-7b": 7.6,
}
# quantization: speed multiplier and quality delta (Fig 6b)
_QUANT_SPEED: Dict[str, float] = {"bf16": 1.0, "fp8wo": 1.15, "int4wo-128": 1.3, "int4wo-32": 1.25}

# reference: Qwen3-8B bf16 on A100 under SGLang
_REF_PREFILL_TPS = 8000.0   # prompt tokens/s
_REF_DECODE_TPS = 95.0      # per-stream decode tokens/s at low batch
_REF_SATURATION = 24        # streams before decode throughput is shared

# KV-memory admission is a TOKEN budget (prompt + output reserved per stream),
# not a stream count; this converts the legacy max_concurrency stream limit
# into tokens at the paper workload's mean footprint (~512 prompt + ~5k output)
_KV_TOKENS_PER_STREAM = 6144

# --- disaggregated prefill/decode transfer cost (DESIGN.md §6.1-disagg) -----
# KV bytes per token for the reference model (Qwen3-8B bf16: K+V tensors x
# 36 layers x 8 KV heads x 128 head_dim x 2 bytes/elem)
_KV_BYTES_PER_TOKEN = 2 * 36 * 8 * 128 * 2              # 147456 B/token
# effective inter-node KV link (10 Gb/s datacenter ethernet) plus a fixed
# per-handoff setup cost (connection + block-table metadata)
_TRANSFER_BYTES_PER_S = 1.25e9
_TRANSFER_BASE_S = 0.002
# EMA step for the router's per-node observed transfer rate: each completed
# handoff window updates rate <- (1 - beta) * rate + beta * observed, seeded
# from _TRANSFER_BYTES_PER_S so routing matches the static model until real
# ExecutorLoad.handoff_bytes observations move it (core/network._est_wait).
_TRANSFER_EMA_BETA = 0.2

# --- gossip load-dissemination plane (DESIGN.md §6.2-gossip) ----------------
# Digests of ExecutorLoad piggyback on gossip rounds at the same cadence as
# membership heartbeats; routing then ranks candidates from the local stale
# digest table instead of probing every candidate inline.
_DIGEST_INTERVAL_S = 1.0
# Staleness discount: a digest of age `a` is trusted with weight
# exp(-a / _DIGEST_STALENESS_TAU_S); as trust decays the inferred pressure
# regresses toward the neutral prior below (an unknown peer is assumed
# half-loaded, neither a magnet nor a repellent for offloads).
_DIGEST_STALENESS_TAU_S = 5.0
_DIGEST_PRESSURE_PRIOR = 0.5
# Pressure gap (after discounting) under which the digest ranking cannot
# separate the top two candidates and routing falls back to live probes.
_DIGEST_TIE_EPS = 0.05

# --- cross-request prefix caching (DESIGN.md §6.1-prefix) -------------------
# EMA step for the executor's online cache-hit-rate estimate: per admitted
# request, hit_rate <- (1 - beta) * hit_rate + beta * (cached / prompt).
# Seeds at 0.0 (a fresh pool has nothing cached), so sim and engine agree
# until observations move it — same pattern as _SPEC_ALPHA0 below.
_PREFIX_HIT_EMA_BETA = 0.2
# Resident-prefix fingerprint width: a load digest advertises up to this many
# distinct prefix identities (most recently touched first) for cache-affinity
# dispatch, and the simulated executor's prefix cache retains this many
# distinct prefixes (LRU beyond it) so the fingerprint IS the sim cache.
_PREFIX_FINGERPRINT_K = 8

# --- speculative decoding (DESIGN.md §6.1-spec) -----------------------------
# Default draft depth: k draft tokens verified per target forward.
_SPEC_K = 4
# Prior per-token draft acceptance rate.  This single constant seeds BOTH the
# real engine's online EMA (Engine.spec_alpha) and the simulated
# SpecTokenBucketExecutor's configured rate, so sim and engine start from the
# same expected-tokens-per-step and their admission/estimate decisions agree
# until real observations move the EMA (sim-vs-engine agreement test in
# tests/test_spec.py, same pattern as paged_admit_ok).
_SPEC_ALPHA0 = 0.7
# EMA step for the engine's online acceptance-rate estimate: per verify step,
# alpha <- (1 - beta) * alpha + beta * (accepted / k).
_SPEC_EMA_BETA = 0.1
# Fractional per-verify-step overhead of running the draft model (k draft
# forwards of a ~10x smaller model plus the verify's extra query positions,
# relative to one target decode step).  The sim charges it against decode
# throughput; the real engine measures it (EngineStats.draft_wall_s).
_SPEC_OVERHEAD = 0.15


@dataclass(frozen=True)
class BackendProfile:
    """Resolved capability of one node's serving backend.

    Execution itself lives in ``repro.sim.executor`` (TokenBucketExecutor);
    ``service_time`` is the analytic steady-state formula the executor must
    reduce to at constant occupancy, and may only be called from the
    executor module (grep-guarded in ``tests/test_compat.py``).
    """

    prefill_tps: float
    decode_tps: float          # per-stream, unsaturated
    saturation: int            # concurrent streams at the knee
    max_concurrency: int       # legacy stream-count admission limit
    quality: float             # latent response quality q_i in [0, 1]
    kv_token_budget: int = 0   # KV admission budget in tokens (0 = derive)

    def service_time(self, prompt: int, output: int, n_active: int) -> float:
        """Expected generation wall time with ``n_active`` concurrent streams."""
        share = max(1.0, n_active / self.saturation)
        return prompt / self.prefill_tps + output / (self.decode_tps / share)


def make_profile(model: str = "qwen3-8b", gpu: str = "A100", backend: str = "sglang",
                 quant: str = "bf16", quality: float = 0.5) -> BackendProfile:
    g = _GPU_SCALE[gpu]
    b = _BACKEND_SCALE[backend]
    m = _MODEL_PARAMS_B[model]
    q = _QUANT_SPEED[quant]
    size_scale = 8.2 / m            # vs reference 8B
    prefill = _REF_PREFILL_TPS * g * b * size_scale
    decode = _REF_DECODE_TPS * g * b * q * size_scale ** 0.7
    sat = max(2, int(_REF_SATURATION * g * size_scale))
    return BackendProfile(
        prefill_tps=prefill, decode_tps=decode, saturation=sat,
        max_concurrency=4 * sat, quality=quality,
        kv_token_budget=4 * sat * _KV_TOKENS_PER_STREAM)


# latent quality per model size / quantization, set to reproduce the paper's
# duel win rates (Fig 6a: 0.57/0.53/0.39, Fig 6b: 0.54/0.49/0.47).
_MODEL_QUALITY: Dict[str, float] = {
    "qwen3-32b": 0.80, "qwen3-8b": 0.72, "qwen3-4b": 0.64, "qwen3-0.6b": 0.36,
    "llama3.1-8b": 0.66, "deepseek-qwen-7b": 0.62,
}
_QUANT_QUALITY_DELTA: Dict[str, float] = {"bf16": 0.0, "fp8wo": -0.04, "int4wo-128": -0.20, "int4wo-32": -0.28}
