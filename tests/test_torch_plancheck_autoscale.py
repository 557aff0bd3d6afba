"""The autoscale governor's seeded bugs through both plancheck copies
(a file of its own: each side explores up to 120,000 states)."""

from test_torch_plancheck import twin


def test_flapping_governor_twin():
    """A governor that skips the cooldown check re-arms a same-direction
    action while the cooldown latch is set: cooldown-honored fires with
    the same minimal trace on both sides."""
    result = twin(
        lambda s: lambda: s.plancheck._autoscale_plan(honor_cooldown=False),
        config_name="seeded-flap", max_states=120_000,
        check_livelock=False,
    )
    flap = [v for v in result.violations
            if v.invariant == "cooldown-honored"]
    assert flap and len(flap[0].trace) <= 8, result.violations


def test_remediation_storm_twin():
    result = twin(
        lambda s: lambda: s.plancheck._autoscale_plan(single_flight=False),
        config_name="seeded-storm", max_states=120_000,
        check_livelock=False,
    )
    names = {v.invariant for v in result.violations}
    assert names & {"no-remediation-storm", "no-opposite-concurrent"}
