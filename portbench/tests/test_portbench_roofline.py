"""The FLOP and byte counts against hand-worked shapes."""

import pytest

from portbench.families.dense.flops import DenseShape
from portbench.harness import roofline


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 989e12) == pytest.approx(1.0)


def test_flash_causal_prefill_by_hand():
    # B=2, S=4, H=4, Hkv=2, D=8: 10 visible pairs per (b, h)
    c = roofline.flash_attention_cost(2, 4, 4, 4, 2, 8, causal=True)
    assert c["flops"] == 4.0 * 2 * 4 * 8 * 10
    # q and out: 2*4*4*8 each; k and v: 2*4*2*8 each; bf16
    assert c["bytes"] == (2 * 256 + 2 * 128) * 2
    full = roofline.flash_attention_cost(2, 4, 4, 4, 2, 8, causal=False)
    assert full["flops"] == 4.0 * 2 * 4 * 8 * 16


def test_flash_offset_causal_counts_each_querys_keys():
    # 2 queries at the end of 5 keys see 4 and 5 keys
    c = roofline.flash_attention_cost(1, 2, 5, 1, 1, 4, causal=True)
    assert c["flops"] == 4.0 * 1 * 1 * 4 * 9


def test_paged_decode_by_hand():
    # two rows of 20 and 1 tokens, table 4 pages of 16, H=8, Hkv=2, D=4
    c = roofline.paged_decode_cost([20, 1], maxp=4, page=16, h=8, hkv=2,
                                   d=4)
    assert c["flops"] == 2.0 * 8 * 4 * (21 + 21)
    kv = (21 + 21) * 2 * 4 * 2
    entries = 2 + 1
    assert c["bytes"] == 2 * 2 * 8 * 4 * 2 + kv + 4 * (entries + 2)


def test_paged_decode_empty_row_reads_its_whole_table():
    c = roofline.paged_decode_cost([0], maxp=2, page=16, h=1, hkv=1, d=2)
    assert c["flops"] == 2.0 * 1 * 2 * 32


def test_dense_flops_by_hand():
    s = DenseShape(n_layers=2, d_model=4, n_heads=2, n_kv_heads=1,
                            head_dim=2, d_ff=8, vocab=10, gated_mlp=True)
    per_layer = 4 * (4 + 2 * 2) + 4 * 4 + 3 * 4 * 8
    assert s.layer_matmul_params == per_layer
    assert s.prefill_flops(3) == (2.0 * 3 * 2 * per_layer
                                  + 4.0 * 2 * 2 * 2 * 6 + 2.0 * 4 * 10)
    assert s.decode_flops(5) == (2.0 * 2 * per_layer + 4.0 * 2 * 2 * 2 * 5
                                 + 2.0 * 4 * 10)
    gelu = DenseShape(1, 4, 2, 1, 2, 8, 10, gated_mlp=False)
    assert gelu.layer_matmul_params == 4 * 8 + 4 * 4 + 2 * 4 * 8


def test_command_r_plus_l8_counts():
    s = DenseShape(8, 12288, 96, 8, 128, 33792, 256000, True)
    # 1.573 B matrix parameters a layer, as the published widths give
    assert s.layer_matmul_params == pytest.approx(1.573e9, rel=1e-3)
