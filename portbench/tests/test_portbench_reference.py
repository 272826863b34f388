"""The plain reference against the port's plain CPU path at smoke size,
on the benchmark's own weights; the weights' layout against the port's."""

import numpy as np
import pytest
import torch

from portbench.families.dense import model, port, reference, weights
from portbench.harness import compare
from portbench.tests import smoke

CONFIGS = ["command-r-plus-104b-l8", "starcoder2-7b-2node"]


def _port(cfg, m):
    return port.port_config(cfg, m, "float32")


@pytest.mark.parametrize("name", CONFIGS)
def test_layout_is_the_ports(name):
    from repro_torch.models import dense
    cfg = smoke.config(name)
    m = model.dims(cfg)
    ours = weights.make(m, 5, "cpu", torch.float32)
    theirs = dense.init(_port(cfg, m), torch.Generator().manual_seed(0),
                        "cpu", torch.float32)

    def flat(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, pre + (k,))
            else:
                yield pre + (k,), tuple(v.shape)

    assert sorted(flat(ours)) == sorted(flat(theirs))
    assert weights.n_params(m) == sum(v.numel() for _, v in
                                      _leaves(ours))


def _leaves(t):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_seeded_and_not_the_identity(name):
    m = model.dims(smoke.config(name))
    a = weights.make(m, 11, "cpu", torch.float32)
    b = weights.make(m, 11, "cpu", torch.float32)
    c = weights.make(m, 12, "cpu", torch.float32)
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves(a), _leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    ln = a["layers"]["ln1"]
    assert (ln["scale"] != 1).any() and (ln["bias"] != 0).any()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_ports_plain_forward(name):
    from repro_torch.models import dense
    cfg = smoke.config(name, layers=3)
    m = model.dims(cfg)
    p = weights.make(m, 3, "cpu", torch.float32)
    toks = torch.as_tensor(np.random.default_rng(0).integers(2, 512, 40))
    port = dense.apply(p, _port(cfg, m), {"tokens": toks[None]})[0]
    with reference.no_tf32():
        ref = reference.logits(p, m, reference.hidden(p, m, toks))
    scale = ref.abs().max()
    assert (port[:, : m.vocab_size] - ref).abs().max() <= 1e-4 * scale


@pytest.mark.parametrize("name", CONFIGS)
def test_served_tokens_of_the_ports_engine_have_no_gap(name):
    """Greedy tokens from the port's paged engine (prefill, page writes,
    paged decode, sampling) on the plain path read gap 0 against the
    reference; an altered token reads a gap."""
    from repro_torch.serving import Engine, GenRequest
    cfg = smoke.config(name)
    m = model.dims(cfg)
    p = weights.make(m, 4, "cpu", torch.float32)
    eng = Engine(_port(cfg, m), p, max_batch=4, bucket=16, paged=True,
                 page_size=16, num_pages=64)
    rng = np.random.default_rng(1)
    reqs = [GenRequest(rid=str(i), tokens=rng.integers(2, 512, n).astype(
        np.int32), max_new=12) for i, n in enumerate((9, 30, 17))]
    eng.serve(reqs)
    for r in reqs:
        ref = reference.served_logits(p, m, r.tokens.tolist(),
                                      r.result.tolist(), "cpu")
        assert float(compare.gaps_sd(ref, r.result.tolist()).max()) < 1e-3
        bad = r.result.tolist()
        bad[3] = int(ref[3].argmin())
        assert float(compare.gaps_sd(ref, bad).max()) > 1.0


def test_gaps_of_a_token_outside_the_vocabulary_are_infinite():
    ref = torch.randn(2, 10)
    g = compare.gaps_sd(ref, [int(ref[0].argmax()), 10])
    assert g[0] == 0 and torch.isinf(g[1])


def test_no_tf32_restores_the_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    with reference.no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before


@pytest.mark.parametrize("name", CONFIGS)
def test_port_departures_are_what_runs_and_reduced_is_depth(name):
    """The file's top level holds the published values; the widths the
    benchmark runs take each ``port_departures`` value instead; the
    benchmark's ``reduced`` names depth alone."""
    cfg = smoke.config(name)
    dep = cfg["port_departures"]
    m = model.dims(cfg)
    assert m.rope_theta == dep["rope_theta"]["run"] != cfg["rope_theta"]
    assert m.eos_id == dep["eos_token_id"]["run"] != cfg["eos_token_id"]
    assert _port(cfg, m).rope_theta == m.rope_theta
    entry = next(c for c in smoke.bench()["configs"] if c["name"] == name)
    assert set(entry["reduced"]) <= {"num_hidden_layers"}
    qk = dict(cfg, port_departures=dict(dep, use_qk_norm={"run": True}))
    with pytest.raises(ValueError, match="q/k norm"):
        model.dims(qk)
