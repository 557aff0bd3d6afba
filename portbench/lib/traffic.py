"""The one generator of the benchmark's inputs, read from a mix file.

The set of sizes and arrival gaps comes from the mix's ``shape_seed``;
the run's ``--seed`` puts that set in another order and picks the token
ids.  So every seed offers the same work, and no two seeds the same
schedule: the order of training's documents (which packing hides), and
in serving which prompt and reply length comes at which arrival, and
the order of the gaps between arrivals.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

EOS = 2  # Mistral's </s>, between packed documents


def _lognormal_ints(rng, spec: dict, n: int) -> np.ndarray:
    """``n`` lengths, lognormal about ``median`` with log-spread
    ``sigma``, clipped to ``[min, max]``."""
    raw = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


def _zipf_ids(rng, n: int, vocab: int, exponent: float,
              order: np.ndarray) -> np.ndarray:
    """Token ids whose frequencies fall off as a Zipf law of
    ``exponent``; ``order`` maps frequency rank to id."""
    ranks = (rng.zipf(exponent, n) - 1) % vocab
    return order[ranks]


def write_train_shards(mix: dict, seed: int, vocab: int, out_dir: str
                       ) -> int:
    """Token shards in the port's format (``data/loader.py``: raw
    little-endian int32, ``<name>.tokens``): documents of lognormal
    length with Zipf-drawn ids, packed end to end with ``EOS`` between
    them, enough for ``mix['rows']`` rows of ``seq + 1`` tokens.
    Returns the tokens written."""
    need = mix["rows"] * (mix["seq"] + 1)
    shapes = np.random.default_rng(mix["shape_seed"])
    lengths = _lognormal_ints(shapes, mix["doc_tokens"], need // 16 + 64)
    lengths = lengths[np.cumsum(lengths + 1) <= need + mix["doc_tokens"]["max"]]
    rng = np.random.default_rng(seed)
    lengths = lengths[rng.permutation(len(lengths))]
    order = rng.permutation(vocab)
    ids = _zipf_ids(rng, int(lengths.sum()), vocab, mix["zipf_exponent"],
                    order)
    stream = np.full(int(lengths.sum() + len(lengths)), EOS, np.int32)
    is_eos = np.zeros(len(stream), bool)
    is_eos[np.cumsum(lengths + 1) - 1] = True
    stream[~is_eos] = ids
    if len(stream) < need:
        stream = np.resize(stream, need)
    os.makedirs(out_dir, exist_ok=True)
    per = -(-need // mix["shards"])
    for i in range(mix["shards"]):
        stream[i * per:(i + 1) * per].astype("<i4").tofile(
            os.path.join(out_dir, f"part-{i:03d}.tokens"))
    return need


@dataclass
class Request:
    index: int
    due: float                  # seconds after the window opens
    prompt: List[int]
    new_tokens: int
    timed: bool = True          # False: sent in the pre-roll, not judged


def serve_schedule(mix: dict, seed: int, seconds: float, vocab: int
                   ) -> List[Request]:
    """The open loop's requests, due in time order: a pre-roll's over
    the ``mix['preroll_s']`` seconds before the window (negative
    ``due``, not timed), then the window's over ``seconds``.  Each part
    is a set of Poisson arrivals at ``mix['rate']`` with lognormal
    prompt and output lengths, drawn from ``shape_seed``; ``seed``
    reorders its (prompt, output) pairs and its gaps, and draws the
    prompt ids, uniform and unshared."""
    shapes = np.random.default_rng(mix["shape_seed"])
    rng = np.random.default_rng(seed)
    rate = float(mix["rate"])
    out: List[Request] = []
    for span, timed in ((float(mix.get("preroll_s", 0.0)), False),
                        (float(seconds), True)):
        if span <= 0:
            continue
        gaps = shapes.exponential(1.0 / rate, int(rate * span * 2) + 64)
        n = int((np.cumsum(gaps) < span).sum())
        plens = _lognormal_ints(shapes, mix["prompt_tokens"], n)
        outs = _lognormal_ints(shapes, mix["output_tokens"], n)
        order = rng.permutation(n)
        dues = np.cumsum(gaps[:n][rng.permutation(n)])
        offset = 0.0 if timed else -span
        for j in range(n):
            k = order[j]
            out.append(Request(
                len(out), offset + float(dues[j]),
                rng.integers(0, vocab, int(plens[k])).tolist(),
                int(outs[k]), timed))
    return out
