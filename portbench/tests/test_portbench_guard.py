"""The metric-set guard: a traced run whose record lacks what a listed
metric reads exits non-zero naming that metric and prints no result; a
run without a card, or with fewer than the cell asks for, exits non-zero
too."""

import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from portbench import run as entry
from portbench.harness import cell
from portbench.tests import smoke

FULL = {
    "counters": {"decode_tokens": 640.0, "decode_steps": 10.0,
                 "prefill_wall_s": 0.5, "decode_wall_s": 0.2},
    "model_flops": {"prefill": 2e14, "decode": 3e12},
    "peak_flops": 989e12,
    "nodes": 2,
    "requests": [{"offloaded": i < 3} for i in range(10)],
    "kernels": {"flash_attention_roofline": {"bound_s": 0.01,
                                             "device_s": 0.03},
                "paged_decode_roofline": {"bound_s": 0.02,
                                          "device_s": 0.04}},
    "device": {"busy_s": 6.0, "window_s": 8.0},
}

# what each reader needs, taken away
LACKS = {
    "offload_share": lambda r: r.update(nodes=1),
    "decode_rows_per_step": lambda r: r["counters"].update(decode_steps=0),
    "prefill_mfu": lambda r: r["model_flops"].update(prefill=0.0),
    "decode_mfu": lambda r: r["counters"].update(decode_wall_s=0.0),
    "flash_attention_roofline": lambda r: r["kernels"].pop(
        "flash_attention_roofline"),
    "paged_decode_roofline": lambda r: r["kernels"].pop(
        "paged_decode_roofline"),
    "device_idle_share": lambda r: r.pop("device"),
}
PER_LAYER = smoke.bench()["per_layer"]


def _record():
    return json.loads(json.dumps(FULL))


def test_every_listed_metric_has_a_lack():
    assert sorted(LACKS) == sorted(e["name"] for e in PER_LAYER)


def test_full_record_reads_every_metric():
    out = cell.read_metrics(PER_LAYER, _record())
    assert out["device_idle_share"]["value"] == pytest.approx(25.0)
    assert out["flash_attention_roofline"]["value"] == pytest.approx(
        100 / 3)
    assert out["decode_rows_per_step"]["value"] == 64.0
    assert out["offload_share"]["value"] == pytest.approx(30.0)


@pytest.mark.parametrize("name", sorted(LACKS))
def test_missing_metric_is_named(name):
    rec = _record()
    LACKS[name](rec)
    with pytest.raises(cell.MissingMetric, match=name):
        cell.read_metrics(PER_LAYER, rec)


@pytest.mark.parametrize("name", sorted(LACKS))
def test_run_exits_non_zero_naming_it_and_prints_nothing(monkeypatch, name):
    rec = _record()
    LACKS[name](rec)

    def traced(spec, *a, **k):
        cell.read_metrics(spec.per_layer, rec)
        raise AssertionError("read_metrics should have raised")

    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setattr(cell, "run", traced)
    listed = next(e for e in PER_LAYER if e["name"] == name)
    wl = listed.get("workloads", [smoke.bench()["workloads"][0]["name"]])[0]
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = entry.main(["--workload", wl, "--seed", "5", "--seconds", "1",
                         "--trace", "1"])
    assert rc != 0
    assert name in err.getvalue()
    assert out.getvalue() == ""


def test_no_card_exits_non_zero_without_a_result():
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = entry.main(["--workload", "cmdr-chat", "--seed", "1",
                         "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


def test_too_few_cards_exits_non_zero(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 0)
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        rc = entry.main(["--workload", "cmdr-chat", "--seed", "1",
                         "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder has no program: the run fails before any result."""
    root = smoke.HERE.parent
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(smoke.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "cmdr-chat", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env={"PATH": "/usr/bin:/bin",
                                         "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
