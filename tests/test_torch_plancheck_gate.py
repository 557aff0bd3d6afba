"""The port's plancheck gate at full depth: every built-in
configuration explored to the end over the port's plan objects, as the
reference gate (tests/test_lint_gate.py) runs the reference's."""

from dcos_commons_tpu_torch.analysis import plancheck


def test_plancheck_repo_gate_on_the_port():
    summary = plancheck.check_all(max_states=120_000)
    assert summary.ok, summary.render()
    assert summary.states_explored >= 10_000, summary.render()
    for result in summary.results:
        assert not result.truncated, result.config
        assert result.livelock_checked, result.config
        assert result.complete_states > 0, result.config
    by_name = {r.config: r for r in summary.results}
    assert set(by_name) == set(plancheck.BUILTIN_CONFIGS)
    for name in ("gang-recovery", "autoscale", "migration",
                 "multislice-recovery"):
        assert by_name[name].states >= 10_000, summary.render()
