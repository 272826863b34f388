"""The control of the comparison at a size a test run holds: the
reference computed in fp8 (weights and activations) reads a gap where the
reference itself reads none, and put in the program's place on a run's
sample it comes out as not correct through the run's own comparison.  The
same casts run on the card at each cell's own size, on the program's
served sample (``tools/control.py``)."""

import numpy as np
import pytest
import torch

from portbench.families.dense import model, reference, weights
from portbench.harness import cell, compare
from portbench.tests import smoke
from portbench.tools.control import fp8, fp8_rows, judge_control


def test_fp8_rows_take_a_scale_each():
    x = torch.stack([torch.linspace(-1, 1, 101), torch.linspace(-8, 8, 101)])
    q = fp8_rows(x)
    assert q[0].abs().max() == pytest.approx(1.0)
    assert q[1].abs().max() == pytest.approx(8.0)


def test_fp8_rounding_is_one_scale_a_tensor():
    w = torch.linspace(-3, 3, 1001)
    q = fp8(w)
    assert q.abs().max() == pytest.approx(3.0)
    assert 0 < (q - w).abs().max() <= 3.0 / 448 * 16 * 1.001


@pytest.mark.parametrize("name", ["command-r-plus-104b-l8",
                                  "starcoder2-7b-2node"])
def test_control_reads_a_gap_where_the_reference_reads_none(name):
    """At every position of a 300-token sequence, the token the fp8
    control puts first lies below the reference's best; the reference's
    own first choices read no gap."""
    m = model.dims(smoke.config(name))
    p = weights.make(m, 9, "cpu", torch.float32)
    toks = torch.as_tensor(np.random.default_rng(9).integers(2, 512, 300))
    with reference.no_tf32():
        ref = reference.logits(p, m, reference.hidden(p, m, toks))
        low = reference.logits(
            p, m, reference.hidden(p, m, toks, fp8, fp8_rows), fp8, fp8_rows)
    assert float(compare.first_choice_gaps_sd(ref, ref).max()) == 0.0
    assert float(compare.first_choice_gaps_sd(ref, low).max()) > 0.05


@pytest.mark.parametrize("workload,config", [
    ("cmdr-chat", "command-r-plus-104b-l8"),
    ("sc2-complete-hot", "starcoder2-7b-2node")])
def test_control_in_the_programs_place_is_not_correct(workload, config):
    """On a sample the port's paged engine served (plain path, node 0's
    weights from the seed), the run's comparison reads the program within
    its limit and ``correct``; the fp8 control put in its place, judged by
    the same comparison and limit, is not.  The sample is six requests of
    64 served tokens each through 4 layers: at smoke widths fp8 rounds each
    logit less, relative to the logits' spread, than at the cells' own
    (two layers and 160 positions read cmdr's control at 0.16-0.23 of its
    0.25, three seeds; this size reads 0.42-0.48)."""
    from portbench import families
    from repro_torch.serving import Engine, GenRequest
    seed, cpu = 2**31 + 99, torch.device("cpu")
    spec = cell.spec_of(smoke.bench(), workload)
    cfg = smoke.config(config, layers=4)
    fam = families.load(cfg["family"])
    m = fam.dims(cfg)
    params = cell.node_weights(fam, m, cfg, seed, cpu, "float32")
    eng = Engine(fam.port_config(cfg, m, "float32"), params[0],
                 **cfg["deployment"]["engine"])
    rng = np.random.default_rng(seed)
    reqs = [GenRequest(rid=str(i), tokens=rng.integers(2, 512, n).astype(
        np.int32), max_new=64) for i, n in enumerate((9, 30, 17, 50, 24, 40))]
    eng.serve(reqs)
    sampled = [cell.Sampled(r.rid, 0, r.tokens.tolist(), r.result.tolist())
               for r in reqs]
    limit = float(cfg["checks"]["max_gap_sd"])
    gap = cell.widest_gap(fam, m, params, sampled, cpu)
    checks = {"max_gap_sd": {"value": gap, "limit": limit}}
    assert cell.verdict(checks)
    o = cell.Outcome({}, checks, True, len(reqs), 0, {}, None, [], sampled)
    ctl = judge_control(spec, o, seed, cpu, dtype="float32", cfg=cfg)
    c = ctl["checks"]["max_gap_sd"]
    assert not ctl["correct"] and c["value"] > c["limit"], c
