"""The operation and byte counts against counts made by hand."""

import json
import os

import pytest

from portbench.lib import counts
from portbench.lib.counts import Geometry
from portbench.lib.harness import ROOT
from portbench.lib.peaks import bound


def geometry(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return Geometry.from_config(json.load(f))


def test_mistral_parameters_by_hand():
    g = geometry("mistral-7b-v0.3")
    # wq 4096x4096, wk and wv 4096x1024, wo 4096x4096
    assert g.attn_params() == 2 * 4096 * 4096 + 2 * 4096 * 1024
    assert g.ffn_params_active() == 3 * 4096 * 14336
    per_layer = 41_943_040 + 176_160_768
    assert g.matmul_params_per_token() == 32 * per_layer + 32768 * 4096
    # the tied embedding once, two norms a layer and the final norm
    assert g.param_count() == (32 * per_layer + 32768 * 4096
                               + 32 * 2 * 4096 + 4096)
    assert g.weight_bytes() == 2 * g.param_count()
    assert g.kv_bytes_per_position() == 32 * 2 * 8 * 128 * 2


def test_mixtral_active_parameters_by_hand():
    g = geometry("mixtral-8x7b-v0.1-pp8")
    assert (g.n_layers, g.n_experts, g.top_k, g.vocab) == (4, 8, 2, 32000)
    expert = 3 * 4096 * 14336
    assert g.ffn_params_active() == 2 * expert + 4096 * 8
    assert g.ffn_params() == 8 * expert + 4096 * 8
    router = 4 * 4096 * 8
    assert g.weight_bytes() == 2 * (g.param_count() - router) + 4 * router
    assert counts.moe_capacity(1024, 2, 8, 1.5) == 384


def test_train_flops_by_hand():
    g = geometry("mistral-7b-v0.3-pp2")
    tokens = 4 * 4096
    dense = 6 * tokens * (16 * (41_943_040 + 176_160_768) + 32768 * 4096)
    # causal attention forward, 2 products over s^2/2 pairs of each of
    # 4 x 32 heads, 16 layers; the backward twice the forward
    attn = 3 * 16 * (2 * 2 * 4 * 32 * 4096 * 4096 * 128 / 2)
    assert g.train_flops(4, 4096) == pytest.approx(dense + attn, rel=1e-12)


def test_kernel_bounds_match_the_kernel_table():
    # PERF.md's kernel table, batch-12 flagship shapes: K1 [24576, 2048]
    # bf16 0.0601 ms (bytes); K2/K3/K4 [192, 2048, 2048, 128] 0.2086 /
    # 0.3128 / 0.4171 ms (operations; the table counts the diagonal's
    # pairs too, s (s + 1) / 2, here s^2 / 2: 0.05% apart)
    assert bound(counts.rmsnorm_bytes(24576, 2048, 2), 0.0)[0] * 1e3 == \
        pytest.approx(0.0601, abs=5e-5)
    for fn, ms in ((counts.flash_fwd_flops, 0.2086),
                   (counts.flash_dq_flops, 0.3128),
                   (counts.flash_dkv_flops, 0.4171)):
        t, kind = bound(0.0, fn(192, 2048, 128))
        assert kind == "operations"
        assert t * 1e3 == pytest.approx(ms, rel=1e-3)
    assert counts.flash_fwd_bytes(2, 8, 4, 2) == 4 * 2 * 8 * 4 * 2 + 4 * 2 * 8


def test_serving_counts_by_hand():
    g = Geometry(vocab=10, d_model=4, n_layers=2, n_heads=2, n_kv_heads=1,
                 head_dim=2, d_ff=3)
    trunk = 2 * (4 * (2 * 4 + 2 * 2) + 3 * 4 * 3)    # 2 layers
    assert g.token_flops(5, with_head=False) == 2 * trunk + 4 * 2 * 2 * 2 * 6
    assert g.token_flops(0, with_head=True) == \
        2 * trunk + 4 * 2 * 2 * 2 * 1 + 2 * 10 * 4
    # a chunk of 3 tokens from position 2: keys 3 + 4 + 5
    assert g.prefill_chunk_flops(2, 3) == \
        2 * trunk * 3 + 4 * 2 * 2 * 2 * 12 + 2 * 10 * 4
    kv = 2 * 2 * 1 * 2 * 2                               # per position
    weights = 2 * g.param_count()
    assert g.decode_bytes([0, 9]) == weights + (1 + 10) * kv + 2 * kv \
        + 2 * 10 * 4
    assert counts.head_flops(3, 4, 10) == 2 * 3 * 4 * 10
    assert counts.moe_onehot_flops(8, 4, 3, 2) == 2 * 8 * 4 * 3 * 2
    assert counts.moe_expert_flops(4, 3, 2, 5) == 6 * 4 * 3 * 2 * 5
    assert counts.moe_routing_flops(8, 2, 4) == 2 * 8 * 2 * 4
