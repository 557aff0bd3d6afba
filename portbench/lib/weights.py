"""Random weights from the seed, made by the benchmark on the device in
the dtype they are served in, one call per leaf.

The tree is the port's layout (``models/transformer.py``): ``embed
[vocab, d]``, ``layers`` (every leaf stacked on a leading layer axis)
and ``final_norm [d]``.  The scales are the port's ``init_params``
scales.  Each leaf has its own generator, seeded from the run's seed
and the leaf's place, so one leaf can be made again alone, bit for bit
(the reference does so, and so does the training set-up's reading of
each leaf's change).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from portbench.lib.counts import Geometry

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def leaf_seed(seed: int, index: int) -> int:
    """A generator seed per (run seed, leaf index)."""
    x = (int(seed) * 1_000_003 + (index + 1) * _MIX) & ((1 << 64) - 1)
    x ^= x >> 29
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 32
    return x & _MASK


def leaf_specs(g: Geometry) -> List[Tuple[str, tuple, str, float]]:
    """(path, shape, dtype name, scale) of every leaf in tree order; a
    scale of 0 marks a norm weight, made as ones."""
    n, d, f = g.n_layers, g.d_model, g.d_ff
    q, kv = g.n_heads * g.head_dim, g.n_kv_heads * g.head_dim
    dt = g.dtype
    specs = [
        ("embed", (g.vocab, d), dt, d ** -0.5),
        ("layers/attn_norm", (n, d), dt, 0.0),
        ("layers/wq", (n, d, q), dt, d ** -0.5),
        ("layers/wk", (n, d, kv), dt, d ** -0.5),
        ("layers/wv", (n, d, kv), dt, d ** -0.5),
        ("layers/wo", (n, q, d), dt, q ** -0.5),
        ("layers/mlp_norm", (n, d), dt, 0.0),
    ]
    if g.n_experts:
        e = g.n_experts
        specs += [
            ("layers/router", (n, d, e), "float32", d ** -0.5),
            ("layers/w_gate", (n, e, d, f), dt, d ** -0.5),
            ("layers/w_up", (n, e, d, f), dt, d ** -0.5),
            ("layers/w_down", (n, e, f, d), dt, f ** -0.5),
        ]
    else:
        specs += [
            ("layers/w_gate", (n, d, f), dt, d ** -0.5),
            ("layers/w_up", (n, d, f), dt, d ** -0.5),
            ("layers/w_down", (n, f, d), dt, f ** -0.5),
        ]
    specs.append(("final_norm", (d,), dt, 0.0))
    return specs


def make_leaf(g: Geometry, seed: int, index: int, device, dtype=None):
    """Leaf ``index`` of ``leaf_specs`` (in ``dtype`` when given: the
    reference draws the same values and widens them)."""
    import torch

    path, shape, dt, scale = leaf_specs(g)[index]
    want = getattr(torch, dt)
    if scale == 0.0:
        t = torch.ones(shape, dtype=want, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
        t = torch.randn(shape, generator=gen, device=device, dtype=want)
        t.mul_(scale)
    return t if dtype is None else t.to(dtype)


def iter_leaves(g: Geometry, seed: int, device) -> Iterator[Tuple[str, object]]:
    for i, (path, *_rest) in enumerate(leaf_specs(g)):
        yield path, make_leaf(g, seed, i, device)


def make_params(g: Geometry, seed: int, device) -> Dict[str, object]:
    """The port's param tree."""
    tree: Dict[str, object] = {"layers": {}}
    for path, t in iter_leaves(g, seed, device):
        if path.startswith("layers/"):
            tree["layers"][path[len("layers/"):]] = t
        else:
            tree[path] = t
    return tree


def tree_paths(tree: Dict[str, object]) -> List[str]:
    """The paths of a port tree in ``tree_leaves`` order (sorted keys,
    as the port's ``utils/tree.py`` walks a dict)."""
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out += [f"{key}/{k}" for k in sorted(tree[key])]
        else:
            out.append(key)
    return out


def get(tree: Dict[str, object], path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node
