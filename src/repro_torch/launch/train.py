"""Training launcher on PyTorch: runs a real training loop.

Port of ``repro.launch.train``, with the same flags and printed lines.
On the card (the default) it trains the full-width config in bfloat16;
with ``--smoke`` the reduced same-family variant in float32, which is
what the reference trains on the CPU; ``--device cpu`` runs the kernels'
plain versions::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --steps 50 --batch 8 --seq 128 --smoke --device cpu

The audio family trains on zero ``encoder_embeds`` and the configs that
take embeddings (``embeds_input``) on one-hot embeddings of ``tokens %
d_model``, as the reference's launcher feeds them.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.serve import require_device
from repro_torch.models.config import ModelConfig
from repro_torch.training import AdamWConfig, init_state, make_train_step
from repro_torch.training import checkpoint as ckpt


def model_batch(cfg: ModelConfig, raw: Dict[str, np.ndarray],
                device: torch.device) -> Dict[str, torch.Tensor]:
    """A pipeline batch on ``device`` with the inputs ``cfg``'s family
    takes: zero ``encoder_embeds`` (B, encoder_seq, d) for the audio
    family, one-hot ``embeds`` of ``tokens % d_model`` in place of the
    tokens for an ``embeds_input`` config."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    b = batch["labels"].shape[0]
    if cfg.family == "audio":
        batch["encoder_embeds"] = torch.zeros(
            (b, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
            device=device)
    if cfg.embeds_input:
        tokens = batch.pop("tokens")
        batch["embeds"] = torch.nn.functional.one_hot(
            (tokens % cfg.d_model).long(), cfg.d_model).float()
    return batch


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 1e-3, seed: int = 0,
          device: str | torch.device = "cuda",
          checkpoint: Optional[str] = None) -> Dict:
    """Train ``cfg`` from seeded random weights (a generator on ``device``
    seeded with ``seed``) on the token pipeline for ``steps`` AdamW steps
    (warmup a tenth of them, cosine after) and return the final train
    state, each step's metrics as floats with its wall time (``step_s``,
    ended by reading the loss, which waits for the device) and the loop's
    wall time; with ``checkpoint`` the state is saved there."""
    dev = require_device(device)
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"family={cfg.family}")
    opt = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                      total_steps=steps)
    state = init_state(cfg, torch.Generator(dev).manual_seed(seed), dev)
    step_fn = make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=seed))
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        t_step = time.perf_counter()
        state, m = step_fn(state, model_batch(cfg, pipe.batch(i), dev))
        m = {k: float(v) for k, v in m.items()}
        m["step_s"] = time.perf_counter() - t_step
        history.append(m)
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            print(f"step {i:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} "
                  f"gnorm={m['grad_norm']:.2f}")
    wall_s = time.perf_counter() - t0
    print(f"done: {steps} steps in {wall_s:.1f}s")
    if checkpoint:
        ckpt.save(checkpoint, state, step=steps)
        print(f"checkpoint -> {checkpoint}")
    return dict(state=state, history=history, wall_s=wall_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced same-family variant in float32")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke().replace(dtype="float32")
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, seed=args.seed, device=args.device,
          checkpoint=args.checkpoint)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
