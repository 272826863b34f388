"""Train a small dense model for a few hundred steps with the PyTorch port.

The port's counterpart of ``examples/train_small.py``: the same smoke
config in float32, data pipeline, AdamW and checkpoint, and the same
check that the loss drops by at least 0.5.  It runs on the card unless
``--device cpu`` asks for the kernels' plain versions:

    PYTHONPATH=src python examples/train_small_torch.py [--steps 200] \
        [--device cpu]
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.serve import require_device
from repro_torch.launch.train import model_batch
from repro_torch.training import AdamWConfig, init_state, make_train_step
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.tree import leaves


def run(steps: int = 200, arch: str = "qwen3-8b",
        device: str = "cuda") -> dict:
    """Train ``steps`` steps and round-trip the state through a
    checkpoint; returns the first and last losses, the step the
    checkpoint restored and whether every restored leaf equals the
    state's."""
    dev = require_device(device)
    cfg = get_config(arch).smoke().replace(dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    state = init_state(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = sum(x.numel() for x in leaves(state["params"]))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params on {dev}")
    step_fn = make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                    global_batch=8, seed=0))
    first = None
    for i in range(steps):
        state, m = step_fn(state, model_batch(cfg, pipe.batch(i), dev))
        loss = float(m["loss"])
        first = first if first is not None else loss
        if i % 25 == 0 or i == steps - 1:
            print(f"step {i:4d} loss={loss:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.msgpack")
        ckpt.save(path, state, step=steps)
        restored, step = ckpt.restore(path, state)
    equal = all(torch.equal(a, b) for a, b in zip(leaves(state),
                                                  leaves(restored)))
    print(f"checkpoint roundtrip at step {step}, leaves equal: {equal}; "
          f"loss {first:.3f} -> {loss:.3f}")
    return dict(first=first, last=loss, step=step, restored_equal=equal)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = run(args.steps, args.arch, args.device)
    if not out["last"] < out["first"] - 0.5:
        raise SystemExit("training did not reduce loss")
    if not (out["restored_equal"] and out["step"] == args.steps):
        raise SystemExit("checkpoint did not restore equal")


if __name__ == "__main__":
    main()
