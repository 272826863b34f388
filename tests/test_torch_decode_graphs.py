"""The paged decode step as CUDA graphs (``dense.PagedDecodeGraphs``).

CPU (the port alone, fp32): the staged inputs equal what the step
computed inline, on rows that cross a page, ride on the scratch page and
clamp their table index; an engine stays eager off the card
(``decode_graph_steps`` 0) and serves the greedy tokens of the
full-sequence forward, preemption included; and an engine given the
uncaptured composition as its graphs serves the eager engine's logits
bit for bit, through a pool's growth (the graphs are rebuilt over the new
pools).  The composition against the reference's paged decode step is
``tests/test_torch_dense.py``'s rider test.

Card (``gpu``; no JAX here): a graphed engine against an eager one over a
served mix (rows joining and retiring, tables growing across pages, a
preemption, fp and int8 pools, the dense layouts the cells run): the same
greedy tokens, logits within the bf16 tolerance of the decode tests,
every decode step replayed, ``n_layers`` row-2 launches a step, and a
wrapper set on the row-2 entry after capture sees each of them.

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_decode_graphs.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import dense, registry
from repro_torch.serving import Engine, GenRequest
from repro_torch.serving.sampling import masked_logits


def _inline(cfg, bt, lengths, page):
    """The staging ``paged_decode_step`` computed inline before it was cut
    into pieces."""
    maxp = bt.shape[1]
    rows = torch.arange(bt.shape[0], device=bt.device)
    lens = lengths.long()
    phys_page = bt[rows, torch.clamp(lens // page, max=maxp - 1)].long()
    page_slot = lens % page
    attend = (lengths + 1).to(torch.int32)
    pos = dense._step_positions(cfg, lens[:, None])
    return {"pos": pos, "phys_page": phys_page, "page_slot": page_slot,
            "attend": attend}


# (table rows, lengths) at page 16: a row whose write crosses into its
# next page (lengths 16 and 31 -> 32), riders on the scratch page (an
# all-zero row at 0 and at 5), and a row whose page index passes the
# table's width and is clamped to its last column
STAGE_CASES = {
    "crosses_a_page": ([[3, 5, 0], [4, 6, 7]], [16, 32]),
    "last_slot_of_a_page": ([[3, 5, 0], [4, 6, 7]], [15, 31]),
    "riders_on_page_0": ([[3, 0, 0], [0, 0, 0], [0, 0, 0]], [9, 0, 5]),
    "clamped_index": ([[2, 4], [6, 0]], [40, 17]),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-vl-7b"])
def test_staged_inputs_equal_the_inline_step(case, arch):
    cfg = get_config(arch).smoke()
    rows, lens = STAGE_CASES[case]
    bt = torch.tensor(rows, dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32)
    got = dense.paged_decode_inputs(cfg, bt, lengths, 16)
    want = _inline(cfg, bt, lengths, 16)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    if case == "clamped_index":
        assert got["phys_page"].tolist() == [4, 0]
    if case == "riders_on_page_0":
        assert got["phys_page"][1:].tolist() == [0, 0]


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg = get_config("qwen3-8b").smoke().replace(dtype="float32")
    params = registry.init(cfg, torch.Generator().manual_seed(5), "cpu")
    return cfg, params


def _reqs(seed, n, max_prompt=40, max_new_hi=20):
    rng = np.random.default_rng(seed)
    return [GenRequest(rid=f"r{i}",
                       tokens=rng.integers(2, 400, size=int(
                           rng.integers(5, max_prompt + 1))).astype(np.int32),
                       max_new=int(rng.integers(2, max_new_hi + 1)))
            for i in range(n)]


def _greedy(params, cfg, prompt, max_new):
    """A request's greedy result by the full-sequence forward over the
    prompt and its tokens so far, ending as the engine ends a row."""
    toks = list(prompt)
    out = []
    for _ in range(max_new):
        logits = dense.apply(params, cfg, {"tokens": torch.tensor([toks])})
        t = int(torch.argmax(masked_logits(logits[0, -1],
                                           cfg.vocab_size)))
        out.append(t)
        toks.append(t)
        if t == cfg.eos_id:
            return out[:-1] if len(out) > 1 else out
    return out


# usable pages: a roomy pool, and one too small for the load, which
# preempts (int8 pages: half as many, since the budget holds twice)
POOLS = {"roomy": 64, "pressed": 6}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_cpu_engine_stays_eager_and_serves_the_greedy_tokens(model, pool):
    cfg, params = model
    eng = Engine(cfg, params, paged=True, max_batch=3, bucket=16,
                 page_size=16, num_pages=POOLS[pool])
    reqs = _reqs(11, 6)
    eng.serve(reqs)
    assert eng.stats.decode_steps > 0
    assert eng.stats.decode_graph_steps == 0
    assert eng._graphs is None
    if pool == "pressed":
        assert eng.stats.preempted >= 1
    for r in reqs:
        np.testing.assert_array_equal(
            r.result, _greedy(params, cfg, r.tokens, r.max_new),
            err_msg=r.rid)


def _uncaptured(params, cfg, pools, batch):
    """The graphs' composition without the capture: what replays on the
    card, run eagerly on the CPU."""
    return dense.PagedDecodeGraphs(params, cfg, pools, batch)


def _lockstep(a, b, reqs_a, reqs_b, on_step=None):
    """Step two engines over the same requests in turns; their carried
    logits must agree on every resident row after every step."""
    for ra, rb in zip(reqs_a, reqs_b):
        a.submit(ra)
        b.submit(rb)
    while a.has_work() or b.has_work():
        a.step()
        b.step()
        rows = [i for i, s in enumerate(a._slots) if s is not None]
        assert rows == [i for i, s in enumerate(b._slots) if s is not None]
        if rows:
            yield a._logits[rows], b._logits[rows]
        if on_step is not None:
            on_step()


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_engine_on_the_composition_serves_the_eager_logits(model, pool):
    cfg, params = model
    kw = dict(paged=True, max_batch=3, bucket=16, page_size=16,
              num_pages=POOLS[pool])
    graphed, eager = Engine(cfg, params, **kw), Engine(cfg, params, **kw)
    graphed._build_graphs = _uncaptured
    built = []
    real = graphed._decode_graphs

    def decode_graphs():
        g = real()
        if not built or built[-1] is not g:
            built.append(g)
        return g

    graphed._decode_graphs = decode_graphs
    # a request longer than the pool, after the rest drain, grows it, so
    # the graphs must be rebuilt over the new pools
    reqs_a, reqs_b = _reqs(4, 5), _reqs(4, 5)
    for rs in (reqs_a, reqs_b):
        rs.append(GenRequest(rid="long", tokens=np.arange(
            16 * POOLS[pool] + 8, dtype=np.int32) % 398 + 2, max_new=12))
    for la, lb in _lockstep(graphed, eager, reqs_a[:5], reqs_b[:5]):
        torch.testing.assert_close(la, lb, rtol=0, atol=0)
    pools_before = graphed._kv
    for la, lb in _lockstep(graphed, eager, reqs_a[5:], reqs_b[5:]):
        torch.testing.assert_close(la, lb, rtol=0, atol=0)
    assert graphed._kv is not pools_before
    assert len(built) == 2 and built[-1].pools is graphed._kv
    assert graphed.stats.decode_graph_steps == graphed.stats.decode_steps
    assert eager.stats.decode_graph_steps == 0
    assert graphed.stats.decode_steps == eager.stats.decode_steps > 0
    if pool == "pressed":
        assert graphed.stats.preempted == eager.stats.preempted >= 1
    for ra, rb in zip(reqs_a, reqs_b):
        np.testing.assert_array_equal(ra.result, rb.result, err_msg=ra.rid)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs and kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_config(arch, kv_quant):
    """The arch's smoke layout at the built head width (D = 128), bf16;
    starcoder2 without its window, as the port runs it."""
    return get_config(arch).smoke().replace(
        dtype="bfloat16", head_dim=128, n_heads=8, n_kv_heads=2,
        sliding_window=None, kv_quant=kv_quant)


def _perturbed(params, seed):
    """Norm scales and biases moved off their fresh 1 and 0, so that every
    piece's parameters reach the logits."""
    g = torch.Generator(params["embed"].device).manual_seed(seed)
    for name, t in params["layers"].items():
        leaves = t.values() if isinstance(t, dict) else [t]
        for leaf in leaves:
            if leaf.dim() == 2 and not name.startswith("w"):
                leaf.add_(0.1 * torch.randn(leaf.shape, generator=g,
                                            device=leaf.device,
                                            dtype=leaf.dtype))
    return params


CARD_CASES = [("starcoder2-7b", False, "roomy"),
              ("command-r-plus-104b", False, "roomy"),
              ("qwen3-8b", False, "pressed"),
              ("qwen3-8b", True, "pressed")]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_quant,pool", CARD_CASES)
def test_graphed_engine_matches_eager_on_card(cuda, monkeypatch, arch,
                                              kv_quant, pool):
    cfg = _card_config(arch, kv_quant)
    params = _perturbed(registry.init(
        cfg, torch.Generator(cuda).manual_seed(7), cuda), 8)
    kw = dict(paged=True, max_batch=4, bucket=16, page_size=16,
              num_pages=POOLS[pool] // (2 if kv_quant else 1))
    graphed, eager = Engine(cfg, params, **kw), Engine(cfg, params, **kw)
    eager._build_graphs = None
    entry = "paged_decode_int8_cuda" if kv_quant else "paged_decode_cuda"
    wrapper = getattr(ops, entry)
    seen = {"calls": 0, "steps": 0, "launches": wrapper.launches}
    state = {"installed": False}

    def after_step():
        # once the graphs exist, a wrapper set on the row-2 entry must see
        # every launch of every later step, as the benchmark's does
        if graphed._graphs is not None and not state["installed"]:
            real = getattr(ops, entry)

            def counted(*a, **k):
                seen["calls"] += 1
                return real(*a, **k)

            monkeypatch.setattr(ops, entry, counted)
            state["installed"] = True
            seen["steps"] = graphed.stats.decode_steps

    reqs_a, reqs_b = _reqs(21, 9, max_prompt=60), _reqs(21, 9, max_prompt=60)
    bit_equal = True
    launches0 = wrapper.launches
    for la, lb in _lockstep(graphed, eager, reqs_a, reqs_b, after_step):
        bit_equal &= torch.equal(la, lb)
        np.testing.assert_allclose(la.float().cpu().numpy(),
                                   lb.float().cpu().numpy(),
                                   atol=2e-2, rtol=1e-2)
    torch.cuda.synchronize()
    print(f"{arch} kv_quant={kv_quant}: logits bit-equal {bit_equal}")
    st, se = graphed.stats, eager.stats
    assert graphed._graphs is not None and eager._graphs is None
    assert st.decode_graph_steps == st.decode_steps == se.decode_steps > 0
    assert se.decode_graph_steps == 0
    if pool == "pressed":
        assert st.preempted == se.preempted >= 1
    # both engines launched row 2: n_layers a decode step each
    assert wrapper.launches - launches0 == 2 * cfg.n_layers * st.decode_steps
    assert state["installed"]
    after = st.decode_steps - seen["steps"]
    assert after > 0
    # the wrapper counted the eager engine's launches too
    assert seen["calls"] == 2 * cfg.n_layers * after
    for ra, rb in zip(reqs_a, reqs_b):
        np.testing.assert_array_equal(ra.result, rb.result, err_msg=ra.rid)
