"""Small stand-ins for the cells' configurations and traffic, for the CPU
tests: the same layouts at widths a test run holds."""

import copy
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]


def config(name: str, layers: int = 2) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(hidden_size=128, intermediate_size=256, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=layers,
               vocab_size=512, head_dim=32)
    dep = cfg["deployment"]
    dep.pop("port_arch")
    dep["engine"] = dict(dep["engine"], max_batch=4, bucket=16, page_size=16,
                         num_pages=64)
    return cfg


def mix(name: str, rate: float = 20.0) -> dict:
    m = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    m.update(rate_per_s=rate, warmup_s=0.3, drain_s=60.0, sample_requests=3,
             prompt=dict(m["prompt"], median=24, min=8, max=64),
             output=dict(m["output"], median=6, min=2, max=12))
    return m


def bench() -> dict:
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())
