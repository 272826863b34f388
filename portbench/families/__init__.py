"""Model families, each a module of its own found by the ``family`` that a
configuration file names (``families/<family>``).  A family module gives
the harness what is particular to a kind of model, and nothing else:

- ``dims(cfg)``: the widths the benchmark needs from a configuration file
  (an object with ``vocab_size``);
- ``port_config(cfg, dims, dtype)``: the program's ``ModelConfig`` for it;
- ``make_weights(dims, seed, device, dtype)``: one node's parameters in
  the program's layout, made on ``device`` from ``seed``;
- ``served_logits(params, dims, prompt, served, device, cast=, act=)``:
  the plain float32 reference's logits at every position that chose a
  served token, ``cast`` and ``act`` rounding each product's weight and
  activation operands (the control's lower precision);
- ``flops(dims)``: an object with ``prefill_flops(prompt_len)`` and
  ``decode_flops(context)``, the model FLOPs the step metrics count.

Only ``port_config`` touches the program.
"""

import importlib


def load(family: str):
    return importlib.import_module(f"portbench.families.{family}")
