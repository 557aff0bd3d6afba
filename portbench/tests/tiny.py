"""A cell of ``BENCHMARK.json`` cut to a size a CPU test holds: the same
driver, harness, reference and limits, with tiny widths and traffic."""

from __future__ import annotations

from portbench.lib import harness
from portbench.lib.counts import Geometry

TINY_WIDTHS = dict(hidden_size=64, intermediate_size=96,
                   num_attention_heads=4, num_key_value_heads=2,
                   head_dim=16, vocab_size=256, num_hidden_layers=2)


def tiny_context(workload: str, seed: int = 2 ** 31 + 12345,
                 seconds: float = 1.0, trace: bool = False,
                 dtype: str = "float32", root: str = harness.ROOT,
                 bench=None) -> harness.Context:
    ctx = harness.build_context(workload, seed, seconds, trace, root=root,
                                device="cpu", bench=bench)
    cfg = dict(ctx.config, torch_dtype=dtype, **TINY_WIDTHS)
    if cfg.get("num_local_experts"):
        cfg["num_local_experts"] = 4
        cfg["port"] = dict(cfg.get("port", {}), moe_group_size=32)
    ctx.config = cfg
    ctx.geometry = Geometry.from_config(cfg)
    mix = dict(ctx.mix)
    if mix["driver"] == "train":
        mix.update(batch=2, seq=64, rows=32, shards=2,
                   doc_tokens={"median": 20, "sigma": 1.0, "min": 2,
                               "max": 200})
    else:
        mix.update(rate=20.0, preroll_s=0.5, slots=4, max_len=128, page_tokens=8,
                   chunk_tokens=16,
                   prompt_tokens={"median": 20, "sigma": 0.8, "min": 4,
                                  "max": 64},
                   output_tokens={"median": 8, "sigma": 0.5, "min": 2,
                                  "max": 32},
                   drain_s=60, trace_s=0.5, check_requests=1000,
                   check_tokens=10 ** 9)
    ctx.mix = mix
    return ctx
