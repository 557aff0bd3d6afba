"""The port's entry points (``dcos_commons_tpu_torch/entry.py``) held
against the JAX package's ``__graft_entry__.py``.

``entry()`` builds the reference's flagship (vocab 8192, d_model 512, 4
layers, 8 heads, d_ff 1408, seq 1024, bf16, batch 4).  Its forward on
the CPU, fed the reference ``entry()``'s own weights (carried across by
``models/bridge.py``) and tokens, gives the reference's logits within
the bf16 tolerance stated below.  ``dryrun_multichip(4)`` runs every
sharded layout over four gloo processes and prints
``dryrun_multichip: OK`` within its deadline.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dcos_commons_tpu_torch import entry as t_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bf16 logits: the port's and the reference's trunks round to bf16 at
# different points (4 layers of matmuls, norms and softmax), so the
# logits may differ by a few bf16 steps at their scale (2^-8 of a value
# is one step): the largest error within 4 steps of the largest
# |logit|, the mean error within 4 steps of the mean |logit|, and the
# greedy token the same at 95% of the positions or more.
BF16_STEP = 2.0 ** -8
MAX_STEPS, MEAN_STEPS, ARGMAX_AGREE = 4, 4, 0.95


@pytest.fixture(scope="module")
def reference_entry():
    import jax

    import __graft_entry__ as graft

    fn, (params, tokens) = graft.entry()
    out = jax.jit(fn)(params, tokens)
    return params, np.asarray(tokens), np.asarray(out, np.float32)


def test_entry_config_is_the_reference_flagship():
    import jax.numpy as jnp

    from dcos_commons_tpu.models import TransformerConfig as JConfig

    config = t_entry.entry_config()
    ref = JConfig(vocab=8192, d_model=512, n_layers=4, n_heads=8,
                  n_kv_heads=8, d_ff=1408, max_seq=1024, dtype=jnp.bfloat16,
                  remat=False)
    for field in ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
                  "d_ff", "max_seq", "remat"):
        assert getattr(config, field) == getattr(ref, field), field
    assert config.dtype == torch.bfloat16


def test_entry_forward_matches_the_reference_on_its_weights(
        reference_entry):
    from dcos_commons_tpu_torch.models import params_from_jax

    j_params, j_tokens, want = reference_entry
    fn, (params, tokens) = t_entry.entry(device="cpu")
    # the port's own example arguments have the reference's shapes
    assert tuple(tokens.shape) == j_tokens.shape == (4, 1024)
    assert tokens.dtype == torch.int64 and tokens.device.type == "cpu"
    assert params["embed"].dtype == torch.bfloat16
    assert tuple(params["layers"]["wq"].shape) == tuple(
        j_params["layers"]["wq"].shape)
    ported = params_from_jax(j_params, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        got = fn(ported, torch.from_numpy(j_tokens.astype(np.int64)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    scale = np.abs(want).max()
    assert err.max() <= MAX_STEPS * BF16_STEP * scale, (err.max(), scale)
    assert err.mean() <= MEAN_STEPS * BF16_STEP * np.abs(want).mean(), (
        err.mean(), np.abs(want).mean())
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= ARGMAX_AGREE, agree


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_entry.entry()


def test_dryrun_multichip_four_ranks_prints_ok(tmp_path, capsys):
    report = t_entry.dryrun_multichip(4, deadline_s=240,
                                      work_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1].startswith("dryrun_multichip: OK")
    assert set(report["layouts"]) == set(t_entry.LAYOUT_NAMES)
    for name in t_entry.LAYOUT_NAMES:
        assert f"dryrun_multichip {name}: " in out
    layouts = report["layouts"]
    assert layouts["train"]["mesh"]["fsdp"] == 2
    assert layouts["train"]["mesh"]["tp"] == 2
    assert layouts["dcn"]["mesh"]["dcn"] == 2
    assert layouts["serve"]["mesh"]["dp"] == 2
    assert set(layouts["serve"]["tokens"]) == {"native", "int8-kv",
                                               "int8-weights-kv"}
    assert layouts["ring"]["mesh"]["sp"] == layouts["ulysses"]["mesh"]["sp"]
    assert layouts["pipeline"]["mesh"]["pp"] == 2
    assert set(layouts["collectives"]) == {"dp", "dcn"}
    assert layouts["moe-ep"]["mesh"]["ep"] == 4
    for name in ("train", "dcn", "ring", "ulysses", "pipeline",
                 "moe-flagship", "moe-ep"):
        assert abs(layouts[name]["loss"]
                   - layouts[name]["one_process_loss"]) <= t_entry.LOSS_TOL
    # the refusals by design are named, with their own messages
    assert "pipeline_loss_fn" in report["refused"]["make_train_step over pp"]
    assert "no sequence-parallel recipe" in report["refused"][
        "sp without a recipe"]
    assert "tp only" in report["refused"]["serve dp x tp in one cache"]
    for name in report["refused"]:
        assert f"refused by design, {name}: " in out


def test_dryrun_refuses_a_world_its_layouts_cannot_split():
    for n in (0, 1, 3):
        with pytest.raises(ValueError, match="even world"):
            t_entry.dryrun_multichip(n)


def test_dryrun_kills_every_rank_of_a_failed_run(tmp_path, monkeypatch):
    """A rank that fails ends the run at once, its peers killed, with
    the rank logs in the error."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path / "inject"), os.environ.get("PYTHONPATH", "")]))
    inject = tmp_path / "inject"
    inject.mkdir()
    # every rank fails before the rendezvous: torch is unimportable
    (inject / "torch.py").write_text("raise ImportError('no torch here')\n")
    with pytest.raises(RuntimeError, match="no torch here"):
        t_entry.dryrun_multichip(2, deadline_s=60,
                                 work_dir=str(tmp_path / "work"))


def test_module_runs_the_forward_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "dcos_commons_tpu_torch.entry",
         "--device", "cpu", "--dryrun", "0"],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "entry forward: (4, 1024, 8192) torch.float32 on cpu" in out.stdout
