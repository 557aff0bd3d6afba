"""Device half of the continuous-batching engine (port of
``dcos_commons_tpu/serve/pool.py``): prefill-into-slot and the pool
decode step over a persistent slot-pool cache, and the paged arena's
prefill-chunk and decode step (models/decode.py).

PyTorch runs eagerly, so there is nothing to compile: ``warm()`` runs
both entry points once so the kernels are built and the first request
pays nothing.  Caches are updated in place.  A prefill runs only the
prompt's real tokens (the right padding the engine hands over changes
no real token's computation, so leaving it out changes no output).

Per-row sampling: a row with temperature > 0 draws from a
``torch.Generator`` seeded by its request seed and the position of the
token it picks (the prefill pick uses ``true_len - 1``, each decode its
row's ``pos``): a row's stream depends on neither its slot nor its
neighbours, and no seed repeats across steps.  Greedy rows argmax.
The draws differ from the JAX package's (different generators); the
slot-independence property and greedy tokens are what carry over.

Not thread-safe by itself: exactly one thread (the engine loop, or a
gang rank's tick executor) calls the entry points.

The serving gang (``frameworks/serve_gang_worker.py``) passes ``mesh``,
a tp mesh over its ranks, and ``params``, the rank's blocks
(``models.transformer.shard_params``): the port's form of the JAX
pools' three riders.  ``cache_sharding`` is the cache of the rank's own
KV heads (``models.decode``, every head where tp does not divide them);
``put`` has nothing to do, as each rank gets its host arrays from the
tick broadcast and moves them to its own device; ``constrain_out`` is
the all-gather of the logits over tp inside the decode paths, so every
rank picks from the whole ``[b, vocab]`` and returns the same tokens.
Every rank of the gang calls every entry point, ``warm`` included, with
the same arguments.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dcos_commons_tpu_torch.models.decode import (
    decode_step,
    init_kv_cache,
    init_paged_kv_cache,
    paged_decode_step,
    paged_prefill_chunk,
    prefill_into_slot,
    sample_token,
)
from dcos_commons_tpu_torch.serve.paging import pages_for
from dcos_commons_tpu_torch.trace.ranges import profiled


def _generator(seed: int, pos: int, device) -> torch.Generator:
    """The sampling stream of (request seed, position)."""
    return torch.Generator(device=device).manual_seed(
        ((int(seed) & 0x7FFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF)
    )


def _pick_rows(logits, temps, seeds, pos) -> np.ndarray:
    """Per-row next tokens: argmax for greedy rows, a draw from the
    row's (seed, pos) stream for sampling rows.  The copy to the host
    waits for the card."""
    with profiled("pool.sample"):
        out = logits.argmax(dim=-1)
        for row in np.flatnonzero(np.asarray(temps) > 0.0):
            out[row] = sample_token(
                logits[row], float(temps[row]),
                _generator(seeds[row], pos[row], logits.device),
            )
        return out.to(torch.int32).cpu().numpy()


class PoolModel:
    """Owns the slot-pool cache and its two entry points, on the
    device of ``params``."""

    def __init__(self, config, params, slots: int, max_len: int,
                 kv_dtype: str = "native", mesh=None):
        self.config = config
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.mesh = mesh
        self.device = params["embed"].device
        self.cache = init_kv_cache(config, slots, max_len, kv_dtype,
                                   device=self.device, mesh=mesh)

    @torch.inference_mode()
    def prefill(self, tokens: np.ndarray, slot: int, true_len: int,
                temp: float, seed: int) -> int:
        """Admit one right-padded [1, prompt_len] prompt into pool row
        ``slot``; returns the first generated token."""
        toks = torch.as_tensor(
            np.asarray(tokens, np.int64)[:, :true_len], device=self.device
        )
        logits, self.cache = prefill_into_slot(
            self.config, self.params, self.cache, toks, int(slot), true_len,
            self.mesh,
        )
        return int(_pick_rows(logits, [temp], [seed], [true_len - 1])[0])

    @torch.inference_mode()
    def decode(self, tok: np.ndarray, pos: np.ndarray, temps: np.ndarray,
               seeds: np.ndarray, n_active: Optional[int] = None
               ) -> np.ndarray:
        """One decode step over the WHOLE pool; returns next tokens
        [slots] (the engine discards inactive rows').  ``n_active`` is
        the engine's bookkeeping rider; the step covers every slot."""
        pos = np.asarray(pos, np.int64)
        logits, self.cache = decode_step(
            self.config, self.params, self.cache,
            torch.as_tensor(np.asarray(tok, np.int64), device=self.device),
            torch.as_tensor(pos, device=self.device), self.mesh,
        )
        return _pick_rows(logits, temps, seeds, pos)

    def warm(self, prompt_len: int) -> None:
        """Run both entry points once before readiness (kernel builds
        happen here, not on the first request)."""
        self.prefill(np.zeros((1, prompt_len), np.int32), slot=0,
                     true_len=prompt_len, temp=0.0, seed=0)
        self.decode(
            np.zeros(self.slots, np.int32),
            np.full(self.slots, prompt_len, np.int32),
            np.zeros(self.slots, np.float32),
            np.zeros(self.slots, np.int32),
        )


class PagedPoolModel:
    """Device half of the PAGED engine: the prefill-chunk / decode-step
    pair over a persistent page arena of ``pages`` usable pages plus
    the trash page (physical page 0), on the device of ``params``."""

    def __init__(self, config, params, slots: int, max_len: int,
                 page_tokens: int, pages: int, chunk_tokens: int,
                 kv_dtype: str = "native", mesh=None):
        self.config = config
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.pages = pages
        self.chunk_tokens = chunk_tokens
        self.pages_per_row = pages_for(max_len, page_tokens)
        self.mesh = mesh
        self.device = params["embed"].device
        self.cache = init_paged_kv_cache(
            config, pages + 1, page_tokens, kv_dtype, device=self.device,
            mesh=mesh,
        )

    @torch.inference_mode()
    def prefill_chunk(self, tokens: np.ndarray, slot: int,
                      table: np.ndarray, start: int, true_len: int,
                      temp: float, seed: int) -> int:
        """Run one [1, chunk_tokens] prompt chunk at virtual positions
        [start, start + true_len) through ``table``; returns the token
        sampled at the chunk's last real position (meaningful on the
        prompt's final chunk).  ``slot`` is the engine's row id, a
        protocol rider: the math needs only the table."""
        del slot
        with profiled("pool.prefill_chunk"):
            toks = torch.as_tensor(
                np.asarray(tokens, np.int64)[:, :true_len],
                device=self.device,
            )
            logits, self.cache = paged_prefill_chunk(
                self.config, self.params, self.cache, toks,
                torch.as_tensor(np.asarray(table, np.int64),
                                device=self.device),
                start, true_len, self.mesh,
            )
            return int(_pick_rows(logits, [temp], [seed],
                                  [start + true_len - 1])[0])

    @torch.inference_mode()
    def decode(self, tok: np.ndarray, pos: np.ndarray, temps: np.ndarray,
               seeds: np.ndarray, tables: np.ndarray,
               n_active: Optional[int] = None) -> np.ndarray:
        """One decode step over the whole pool through per-row page
        tables."""
        with profiled("pool.decode"):
            pos = np.asarray(pos, np.int64)
            logits, self.cache = paged_decode_step(
                self.config, self.params, self.cache,
                torch.as_tensor(np.asarray(tok, np.int64),
                                device=self.device),
                torch.as_tensor(pos, device=self.device),
                torch.as_tensor(np.asarray(tables, np.int64),
                                device=self.device),
                self.mesh,
            )
            return _pick_rows(logits, temps, seeds, pos)

    def export_page(self, page: int) -> dict:
        """Snapshot one physical page as host numpy, every cache key
        included (int8 arenas ship their scales).  bf16 pages travel as
        f32, which holds every bf16 value exactly (numpy has no bf16).
        Single-caller contract like ``decode``."""
        out = {}
        for key, arr in self.cache.items():
            page_t = arr[:, page]
            if page_t.dtype == torch.bfloat16:
                page_t = page_t.float()
            out[key] = page_t.cpu().numpy()
        return out

    def import_page(self, page: int, payload: dict) -> None:
        """Splice one exported page into physical page ``page`` of this
        arena; keys must match this pool's cache layout."""
        if set(payload) != set(self.cache):
            raise ValueError(
                f"page payload keys {sorted(payload)} do not match "
                f"arena keys {sorted(self.cache)} (kv_dtype mismatch?)"
            )
        for key, arr in self.cache.items():
            arr[:, page] = torch.as_tensor(
                np.asarray(payload[key]), device=self.device
            ).to(arr.dtype)

    def warm(self) -> None:
        """Run both entry points once before readiness.  All tables are
        zero, so every write lands in the trash page."""
        self.prefill_chunk(
            np.zeros((1, self.chunk_tokens), np.int32), slot=0,
            table=np.zeros(self.pages_per_row, np.int32),
            start=0, true_len=self.chunk_tokens, temp=0.0, seed=0,
        )
        self.decode(
            np.zeros(self.slots, np.int32),
            np.zeros(self.slots, np.int32),
            np.zeros(self.slots, np.float32),
            np.zeros(self.slots, np.int32),
            np.zeros((self.slots, self.pages_per_row), np.int32),
        )
