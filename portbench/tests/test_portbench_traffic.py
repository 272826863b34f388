"""The traffic generator: the schedule is the cell's own fixed draw, the
seed draws the prompts' tokens, and lengths, rates and origins are as the
files say."""

import numpy as np
import pytest

from portbench.harness import cell, traffic

MIXES = ["chat", "complete-hot"]


def _mix(name):
    return traffic.load(cell.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_tokens_other_seed_other_tokens(name):
    mix = _mix(name)
    a = traffic.schedule(mix, 10.0)
    assert a == traffic.schedule(mix, 10.0)
    ta, tb = (traffic.prompt_tokens(a, 1000, 2**31 + 77) for _ in (0, 1))
    assert all((ta[k] == tb[k]).all() for k in ta)
    tc = traffic.prompt_tokens(a, 1000, 2**31 + 78)
    assert not all((ta[k] == tc[k]).all() for k in ta)


@pytest.mark.parametrize("name", MIXES)
def test_schedule_seeds_reorder_the_same_work(name):
    mix = _mix(name)
    a = traffic.schedule(dict(mix, schedule_seed=1), 10.0)
    b = traffic.schedule(dict(mix, schedule_seed=2), 10.0)
    assert [x.at for x in a] != [x.at for x in b]
    for phase in traffic.PHASES:
        pa = [x for x in a if x.phase == phase]
        pb = [x for x in b if x.phase == phase]
        for key in ("prompt_len", "output_len", "origin"):
            assert sorted(getattr(x, key) for x in pa) == \
                sorted(getattr(x, key) for x in pb)
        gaps = lambda xs, t0: np.sort(np.diff([t0] + [x.at for x in xs]))
        t0 = {"warmup": 0.0, "window": mix["warmup_s"],
              "drain": mix["warmup_s"] + 10.0}[phase]
        assert np.allclose(gaps(pa, t0), gaps(pb, t0))


@pytest.mark.parametrize("name", MIXES)
def test_lengths_rates_and_origins_follow_the_file(name):
    mix = _mix(name)
    seconds = 45.0
    arr = traffic.schedule(mix, seconds)
    win = [a for a in arr if a.phase == "window"]
    assert len(win) == round(mix["rate_per_s"] * seconds)
    assert all(mix["warmup_s"] < a.at <= mix["warmup_s"] + seconds + 1e-9
               for a in win)
    for key, spec in (("prompt_len", mix["prompt"]),
                      ("output_len", mix["output"])):
        xs = np.array([getattr(a, key) for a in win])
        assert xs.min() >= spec["min"] and xs.max() <= spec["max"]
        assert abs(np.median(xs) - spec["median"]) <= 0.03 * spec["median"]
        # the spread of a lognormal: log-quartiles at median +- 0.674 sigma
        q1, q3 = np.percentile(np.log(xs), [25, 75])
        assert abs((q3 - q1) / (2 * 0.6745) - spec["sigma"]) < 0.05
    share = {o: sum(a.origin == o for a in win) / len(win)
             for o in mix["origins"]}
    for o, w in mix["origins"].items():
        assert abs(share[o] - w / sum(mix["origins"].values())) < 0.02


def test_prompt_tokens_avoid_the_pad_and_eos_ids():
    arr = traffic.schedule(_mix("chat"), 5.0)
    toks = traffic.prompt_tokens(arr, 300, 9)
    allt = np.concatenate(list(toks.values()))
    assert allt.min() >= 2 and allt.max() < 300
    assert all(len(toks[a.rid]) == a.prompt_len for a in arr)
