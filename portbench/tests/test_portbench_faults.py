"""A run with its timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven at a
tiny size under the cell's own limits, once for each fault the cell
can have (one card: no exchange between chips to leave out)."""

import numpy as np
import pytest
import torch

from portbench.lib import harness
from portbench.tests.tiny import tiny_context

TRAIN = ["mistral-7b-v0.3.train.s4096", "mixtral-8x7b-v0.1.train.s4096"]
SERVE = ["mistral-7b-v0.3.serve.chat"]


def _run(workload):
    result, _ = harness.execute(tiny_context(workload))
    return result


def _state_unchanged(monkeypatch):
    from dcos_commons_tpu_torch.models import transformer

    def make(config, optimizer, **kw):
        def step(params, tokens, targets):
            with torch.no_grad():
                return transformer.loss_fn(config, params, tokens, targets)
        return step

    monkeypatch.setattr(transformer, "make_train_step", make)


def _half_batch(monkeypatch):
    from dcos_commons_tpu_torch.models import transformer

    real = transformer.make_train_step

    def make(config, optimizer, **kw):
        inner = real(config, optimizer, **kw)

        def step(params, tokens, targets):
            half = tokens.shape[0] // 2
            return inner(params, tokens[:half], targets[:half])
        return step

    monkeypatch.setattr(transformer, "make_train_step", make)


def _token_altered(monkeypatch):
    from dcos_commons_tpu_torch.serve import pool

    real = pool.PagedPoolModel.decode

    def decode(self, tok, pos, temps, seeds, tables, n_active=None):
        out = np.array(real(self, tok, pos, temps, seeds, tables, n_active))
        live = np.flatnonzero(np.asarray(tables).any(-1))
        if len(live):
            out[live[0]] = (out[live[0]] + 1) % self.config.vocab
        return out

    monkeypatch.setattr(pool.PagedPoolModel, "decode", decode)


def _half_of_the_rows_left_out(monkeypatch):
    from dcos_commons_tpu_torch.serve import pool

    real = pool.PagedPoolModel.decode

    def decode(self, tok, pos, temps, seeds, tables, n_active=None):
        tables = np.array(tables)
        tables[1::2] = 0
        return real(self, tok, pos, temps, seeds, tables, n_active)

    monkeypatch.setattr(pool.PagedPoolModel, "decode", decode)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("fault", [_token_altered,
                                   _half_of_the_rows_left_out],
                         ids=["token_altered", "half_the_rows"])
def test_a_broken_decode_step_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(workload)["correct"]
