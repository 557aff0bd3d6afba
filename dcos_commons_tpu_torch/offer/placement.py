"""Placement rules: which hosts may a pod instance land on (port of
``dcos_commons_tpu/offer/placement.py``, line for line but the host
type and the vocabulary below).

Reference: offer/evaluate/placement/ (38 classes, SURVEY.md section
2.1): And/Or/Not combinators, Hostname/Attribute/Region/ZoneRule,
TaskTypeRule colocate/avoid, MaxPerHostname/Zone/Region/Attribute,
RoundRobinByHostname/Zone, string matchers Exact/Regex/Any, and
MarathonConstraintParser for the JSON dialect
(`[["hostname", "UNIQUE"]]`, GROUP_BY, CLUSTER, LIKE/UNLIKE, MAX_PER,
IS) accepted in the YAML ``placement:`` field.

Accelerator vocabulary: ``same-slice`` (all instances of a pod on one
fabric, the ``slice_id`` of its hosts: the group of 8-GPU NVLink nodes
one NCCL gang can join) and ``generation:h100`` (GPU generation
match).  Which hosts of a fabric a gang takes is not a per-host rule:
offer/nvlink.py picks them during gang evaluation.  The spec
validators (``specification/validation.py``) use the parser alone.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from dcos_commons_tpu_torch.common import TaskInfo
from dcos_commons_tpu_torch.offer.inventory import (
    HostIndex,
    ResourceSnapshot,
    GpuHost,
    host_field,
)
from dcos_commons_tpu_torch.offer.outcome import EvaluationOutcome


@dataclass
class PlacementContext:
    """What rules may consult: the other tasks and the host map.

    Reference: PlacementRule.filter(offer, allTasks) — rules see every
    launched task so they can count/colocate/avoid.

    Rules call ``tasks_of_pod``/``count_on``/``field_values`` once per
    candidate host per instance, so all three memoize their scans
    (they are pure in ``existing_tasks``/``hosts``).  Task additions
    mid-evaluation MUST go through ``record_tasks`` — it invalidates
    the task-derived memos; mutating ``existing_tasks`` in place after
    the first rule ran would serve stale counts.

    Fleet-scale path: when ``task_index`` (pod_type -> instance-key ->
    task list, built once per cycle by EvaluationContext) is supplied,
    per-pod instance lists and counts come from the index — no
    per-requirement scan over the fleet's whole task list.
    ``excluded_names`` are the requirement's own tasks (a relaunch
    must not block its own placement).
    """

    pod_type: str
    existing_tasks: List[TaskInfo] = field(default_factory=list)
    hosts: Dict[str, GpuHost] = field(default_factory=dict)
    task_index: Optional[Dict[str, Dict[str, List[TaskInfo]]]] = None
    excluded_names: frozenset = frozenset()
    _instances_memo: Dict[str, List[TaskInfo]] = field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _counts_memo: Dict[tuple, Dict[str, int]] = field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _values_memo: Dict[str, set] = field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _recorded: List[TaskInfo] = field(
        default_factory=list, init=False, repr=False, compare=False
    )

    def record_tasks(self, infos: List[TaskInfo]) -> None:
        """Append just-placed tasks so max-per/group-by rules count
        them for subsequent instances of the same requirement."""
        if self.task_index is not None:
            self._recorded.extend(infos)
        else:
            self.existing_tasks.extend(infos)
        self._instances_memo.clear()
        self._counts_memo.clear()

    def host_field(self, host: GpuHost, field_name: str) -> str:
        return host_field(host, field_name)

    def field_values(self, field_name: str) -> set:
        """Every distinct value of ``field_name`` across the fleet."""
        values = self._values_memo.get(field_name)
        if values is None:
            values = {
                host_field(h, field_name) for h in self.hosts.values()
            }
            self._values_memo[field_name] = values
        return values

    def tasks_of_pod(self, pod_type: str) -> List[TaskInfo]:
        # one counted entry per pod instance (not per task)
        cached = self._instances_memo.get(pod_type)
        if cached is None:
            seen = {}
            if self.task_index is not None:
                for key, infos in self.task_index.get(pod_type, {}).items():
                    for info in infos:
                        if info.name not in self.excluded_names:
                            # sibling tasks of one instance share the
                            # host, so any non-excluded one represents
                            # the instance for placement purposes
                            seen[key] = info
                            break
                extra = self._recorded
            else:
                extra = self.existing_tasks
            # recorded (just-placed) tasks are NEVER excluded: they
            # carry this requirement's own names, but an earlier
            # instance of a multi-instance requirement must count for
            # max-per/group-by on the later ones (the legacy path
            # appends them unfiltered for the same reason)
            for info in extra:
                if info.pod_type == pod_type:
                    seen[f"{info.pod_type}-{info.pod_index}"] = info
            cached = list(seen.values())
            self._instances_memo[pod_type] = cached
        return cached

    def counts_for(self, field_name: str, pod_type: str) -> Dict[str, int]:
        """Instance count per distinct field value (memoized) — the
        shared basis of count_on and index pre-filtering, so a rule's
        filter() and its candidate set can never disagree."""
        key = (field_name, pod_type)
        counts = self._counts_memo.get(key)
        if counts is None:
            counts = {}
            for info in self.tasks_of_pod(pod_type):
                host = self.hosts.get(info.agent_id)
                if host is not None:
                    actual = host_field(host, field_name)
                    counts[actual] = counts.get(actual, 0) + 1
            self._counts_memo[key] = counts
        return counts

    def count_on(self, field_name: str, value: str, pod_type: str) -> int:
        return self.counts_for(field_name, pod_type).get(value, 0)


class PlacementRule:
    def filter(
        self, snapshot: ResourceSnapshot, ctx: PlacementContext
    ) -> EvaluationOutcome:
        raise NotImplementedError

    def candidate_host_ids(
        self, ctx: PlacementContext, index: HostIndex
    ) -> Optional[set]:
        """Indexed pre-filtering: the host ids this rule could pass,
        or None when the rule cannot bound its candidates (the
        evaluator then scans).  MUST be a superset of the hosts
        ``filter`` would pass — filter() still runs on every
        candidate, so over-approximation costs time, never
        correctness; UNDER-approximation changes placement."""
        return None

    def candidate_key(self):
        """Hashable identity of this rule's candidate set when it is
        STATIC — a pure function of fleet topology, independent of
        the placement context's task counts — or None when dynamic
        (max-per / group-by / round-robin consult live counts and
        must recompute).  Static sets are memoized per topology
        generation (HostIndex.rule_candidates), so a deploy of N
        instances pays ONE candidate-set computation instead of N
        fleet-sized set algebras)."""
        return None


class PassthroughRule(PlacementRule):
    def filter(self, snapshot, ctx):
        return EvaluationOutcome.ok("passthrough")


class AndRule(PlacementRule):
    def __init__(self, rules: Sequence[PlacementRule]):
        self.rules = list(rules)

    def filter(self, snapshot, ctx):
        children = [r.filter(snapshot, ctx) for r in self.rules]
        passed = all(c.passed for c in children)
        outcome = EvaluationOutcome(
            passed, "and", "all passed" if passed else "a sub-rule failed"
        )
        outcome.children = children
        return outcome

    def candidate_host_ids(self, ctx, index):
        # intersection of every bounding child; an unbounded child
        # (None) constrains nothing
        out = None
        for rule in self.rules:
            cand = rule.candidate_host_ids(ctx, index)
            if cand is None:
                continue
            out = set(cand) if out is None else out & cand
            if not out:
                return out
        return out

    def candidate_key(self):
        # static only when EVERY bounding child is static: a dynamic
        # child changes the intersection between instances
        keys = []
        for rule in self.rules:
            key = rule.candidate_key()
            if key is None and rule.candidate_host_ids.__func__ is not \
                    PlacementRule.candidate_host_ids:
                return None
            keys.append(key)
        return ("and", tuple(keys))


class OrRule(PlacementRule):
    def __init__(self, rules: Sequence[PlacementRule]):
        self.rules = list(rules)

    def filter(self, snapshot, ctx):
        children = [r.filter(snapshot, ctx) for r in self.rules]
        passed = any(c.passed for c in children)
        outcome = EvaluationOutcome(
            passed, "or", "a sub-rule passed" if passed else "no sub-rule passed"
        )
        outcome.children = children
        return outcome

    def candidate_host_ids(self, ctx, index):
        # union; ANY unbounded branch makes the whole rule unbounded
        out: set = set()
        for rule in self.rules:
            cand = rule.candidate_host_ids(ctx, index)
            if cand is None:
                return None
            out |= cand
        return out

    def candidate_key(self):
        keys = []
        for rule in self.rules:
            key = rule.candidate_key()
            if key is None and rule.candidate_host_ids.__func__ is not \
                    PlacementRule.candidate_host_ids:
                return None  # a dynamic bounding child: recompute
            keys.append(key)
        return ("or", tuple(keys))


class NotRule(PlacementRule):
    def __init__(self, rule: PlacementRule):
        self.rule = rule

    def filter(self, snapshot, ctx):
        child = self.rule.filter(snapshot, ctx)
        outcome = EvaluationOutcome(
            not child.passed, "not", f"inverted {child.source}"
        )
        outcome.children = [child]
        return outcome


class FieldMatchRule(PlacementRule):
    """hostname/zone/region/attribute exact or regex match.

    Reference: HostnameRule/ZoneRule/RegionRule/AttributeRule +
    ExactMatcher/RegexMatcher.
    """

    def __init__(self, field_name: str, values: List[str], regex: bool = False,
                 invert: bool = False):
        self.field_name = field_name
        self.values = values
        self.regex = regex
        self.invert = invert

    def filter(self, snapshot, ctx):
        actual = ctx.host_field(snapshot.host, self.field_name)
        if self.regex:
            matched = any(re.fullmatch(v, actual) for v in self.values)
        else:
            matched = actual in self.values
        ok = matched != self.invert
        name = f"{'un' if self.invert else ''}match:{self.field_name}"
        if ok:
            return EvaluationOutcome.ok(name, f"{actual!r} ok")
        return EvaluationOutcome.fail(
            name,
            f"host {snapshot.host.host_id} {self.field_name}={actual!r} "
            f"{'matches' if self.invert else 'not in'} {self.values}",
        )

    def candidate_host_ids(self, ctx, index):
        value_index = index.value_index(self.field_name)
        if self.regex:
            matched: set = set()
            # distinct values are few; the regex runs per value, not
            # per host
            for value, hosts in value_index.items():
                if any(re.fullmatch(v, value) for v in self.values):
                    matched |= hosts
        else:
            matched = set()
            for v in self.values:
                matched |= value_index.get(v, frozenset())
        if self.invert:
            return index.universe() - matched
        return matched

    def candidate_key(self):
        # pure function of host fields: the candidate set (including
        # the O(fleet) inverted-match universe subtraction) only moves
        # when topology does
        return (
            "match", self.field_name, tuple(self.values),
            self.regex, self.invert,
        )


class MaxPerRule(PlacementRule):
    """At most N instances of this pod per distinct field value.

    Reference: MaxPerHostnameRule / MaxPerZoneRule / etc.
    """

    def __init__(self, field_name: str, max_count: int):
        self.field_name = field_name
        self.max_count = max_count

    def filter(self, snapshot, ctx):
        value = ctx.host_field(snapshot.host, self.field_name)
        count = ctx.count_on(self.field_name, value, ctx.pod_type)
        if count < self.max_count:
            return EvaluationOutcome.ok(
                f"max-per-{self.field_name}",
                f"{count}/{self.max_count} on {value!r}",
            )
        return EvaluationOutcome.fail(
            f"max-per-{self.field_name}",
            f"already {count}/{self.max_count} instances of "
            f"{ctx.pod_type!r} on {self.field_name}={value!r}",
        )

    def candidate_host_ids(self, ctx, index):
        # exclude hosts whose field value already carries max_count
        # instances — the same counts filter() consults
        counts = ctx.counts_for(self.field_name, ctx.pod_type)
        saturated = [
            v for v, n in counts.items() if n >= self.max_count
        ]
        if not saturated:
            return index.universe()
        value_index = index.value_index(self.field_name)
        out = set(index.universe())
        for v in saturated:
            out -= value_index.get(v, frozenset())
        return out


class GroupByRule(PlacementRule):
    """Spread instances evenly across field values.

    Reference: RoundRobinByHostname/Zone + marathon GROUP_BY.
    ``expected_values`` bounds the divisor when known (GROUP_BY:n).
    """

    def __init__(self, field_name: str, expected_values: int = 0):
        self.field_name = field_name
        self.expected_values = expected_values

    def filter(self, snapshot, ctx):
        value = ctx.host_field(snapshot.host, self.field_name)
        values = ctx.field_values(self.field_name) | {value}
        divisor = self.expected_values or len(values) or 1
        total = len(ctx.tasks_of_pod(ctx.pod_type)) + 1  # incl. this one
        ceiling = math.ceil(total / divisor)
        count = ctx.count_on(self.field_name, value, ctx.pod_type)
        if count < ceiling:
            return EvaluationOutcome.ok(
                f"group-by-{self.field_name}",
                f"{count}<{ceiling} on {value!r}",
            )
        return EvaluationOutcome.fail(
            f"group-by-{self.field_name}",
            f"{self.field_name}={value!r} already has {count} "
            f"(ceiling {ceiling}) of {ctx.pod_type!r}",
        )

    def candidate_host_ids(self, ctx, index):
        # same ceiling arithmetic as filter(): an up host's value is
        # already in the fleet value set, so the divisor is constant
        # across candidates
        values = ctx.field_values(self.field_name)
        divisor = self.expected_values or len(values) or 1
        total = len(ctx.tasks_of_pod(ctx.pod_type)) + 1
        ceiling = math.ceil(total / divisor)
        counts = ctx.counts_for(self.field_name, ctx.pod_type)
        saturated = [v for v, n in counts.items() if n >= ceiling]
        if not saturated:
            return index.universe()
        value_index = index.value_index(self.field_name)
        out = set(index.universe())
        for v in saturated:
            out -= value_index.get(v, frozenset())
        return out


class TaskTypeRule(PlacementRule):
    """Colocate with / avoid hosts running another pod type.

    Reference: TaskTypeRule.colocateWith / avoid.
    """

    def __init__(self, other_pod_type: str, colocate: bool):
        self.other = other_pod_type
        self.colocate = colocate

    def filter(self, snapshot, ctx):
        hosts_of_other = {
            info.agent_id for info in ctx.tasks_of_pod(self.other)
        }
        on_host = snapshot.host.host_id in hosts_of_other
        name = f"task-type-{'colocate' if self.colocate else 'avoid'}:{self.other}"
        if self.colocate:
            if not hosts_of_other:
                # nothing to colocate with yet: allow anywhere (the
                # reference behaves the same when the target is absent)
                return EvaluationOutcome.ok(name, f"no {self.other!r} tasks yet")
            if on_host:
                return EvaluationOutcome.ok(name, "colocated")
            return EvaluationOutcome.fail(
                name, f"host has no {self.other!r} task"
            )
        if on_host:
            return EvaluationOutcome.fail(
                name, f"host already runs {self.other!r}"
            )
        return EvaluationOutcome.ok(name, "avoided")

    def candidate_host_ids(self, ctx, index):
        hosts_of_other = {
            info.agent_id for info in ctx.tasks_of_pod(self.other)
        }
        if self.colocate:
            if not hosts_of_other:
                return index.universe()  # nothing to colocate with yet
            return hosts_of_other & index.universe()
        return index.universe() - hosts_of_other


class AgentRule(PlacementRule):
    """Pin to / avoid specific host ids.

    Reference: AgentRule (agent-id targeted placement).  The avoid form
    is the maintenance-drain verb: ``agent:avoid:h3`` keeps new
    placements off a host scheduled for maintenance while existing
    tasks drain.
    """

    def __init__(self, host_ids: List[str], avoid: bool = False):
        self.host_ids = set(host_ids)
        self.avoid = avoid

    def filter(self, snapshot, ctx):
        on_list = snapshot.host.host_id in self.host_ids
        name = f"agent-{'avoid' if self.avoid else 'match'}"
        if on_list != self.avoid:
            return EvaluationOutcome.ok(name, snapshot.host.host_id)
        return EvaluationOutcome.fail(
            name,
            f"host {snapshot.host.host_id!r} "
            f"{'is drained' if self.avoid else 'not in'} "
            f"{sorted(self.host_ids)}",
        )

    def candidate_host_ids(self, ctx, index):
        if self.avoid:
            return index.universe() - self.host_ids
        return self.host_ids & index.universe()


class RoundRobinByRule(PlacementRule):
    """Strict round robin: a host's field value may hold a new instance
    only while no other known value holds fewer.

    Reference: RoundRobinByHostname/Attribute/Region/ZoneRule — unlike
    GROUP_BY's ceiling (which allows transient imbalance while filling)
    round robin never lets any value get 2 ahead of the emptiest.
    ``expected_values`` bounds the value set when topology knowledge is
    partial (reference: the optional value-count parameter).
    """

    def __init__(self, field_name: str, expected_values: int = 0):
        self.field_name = field_name
        self.expected_values = expected_values

    def filter(self, snapshot, ctx):
        value = ctx.host_field(snapshot.host, self.field_name)
        values = ctx.field_values(self.field_name) | {value}
        counts = {
            v: ctx.count_on(self.field_name, v, ctx.pod_type) for v in values
        }
        floor = min(counts.values())
        if self.expected_values and len(values) < self.expected_values:
            # declared values not yet visible in the topology are empty
            # by definition (reference: RoundRobin treats unknown
            # declared values as the floor)
            floor = 0
        name = f"round-robin-{self.field_name}"
        if counts[value] <= floor:
            return EvaluationOutcome.ok(
                name, f"{value!r} at {counts[value]} (floor {floor})"
            )
        return EvaluationOutcome.fail(
            name,
            f"{self.field_name}={value!r} has {counts[value]} of "
            f"{ctx.pod_type!r}, another value is at {floor}",
        )

    def candidate_host_ids(self, ctx, index):
        # the floor is computed over the FLEET value set (incl. values
        # seen only on down hosts — count 0), exactly as filter() does
        values = ctx.field_values(self.field_name)
        task_counts = ctx.counts_for(self.field_name, ctx.pod_type)
        counts = {v: task_counts.get(v, 0) for v in values}
        floor = min(counts.values()) if counts else 0
        if self.expected_values and len(values) < self.expected_values:
            floor = 0
        value_index = index.value_index(self.field_name)
        out: set = set()
        for v, n in counts.items():
            if n <= floor:
                out |= value_index.get(v, frozenset())
        return out


class VolumeProfilesRule(PlacementRule):
    """The pod's volumes demand storage profiles (reference: profile
    MOUNT volumes matched against DC/OS storage profiles,
    VolumeEvaluationStage.java): the host must advertise every
    requested profile in its ``volume_profiles`` attribute
    (comma-separated, e.g. ``volume_profiles: "ssd,nvme"``)."""

    def __init__(self, profiles):
        self.profiles = sorted(set(profiles))

    def filter(self, snapshot, ctx):
        advertised = {
            p.strip()
            for p in snapshot.host.attributes.get(
                "volume_profiles", ""
            ).split(",")
            if p.strip()
        }
        missing = [p for p in self.profiles if p not in advertised]
        if not missing:
            return EvaluationOutcome.ok(
                "volume-profiles", ",".join(self.profiles) or "any"
            )
        return EvaluationOutcome.fail(
            "volume-profiles",
            f"host {snapshot.host.host_id} lacks storage profile(s) "
            f"{missing} (advertises {sorted(advertised) or 'none'})",
        )

    def candidate_host_ids(self, ctx, index):
        # the attribute is a free-form comma list: parse each DISTINCT
        # advertised string once (few) instead of per host
        out: set = set()
        for raw, hosts in index.value_index("volume_profiles").items():
            advertised = {p.strip() for p in raw.split(",") if p.strip()}
            if all(p in advertised for p in self.profiles):
                out |= hosts
        return out


class SameSliceRule(PlacementRule):
    """All instances of the pod on one fabric (``slice_id``)."""

    def filter(self, snapshot, ctx):
        slices = {
            ctx.hosts[i.agent_id].slice_id
            for i in ctx.tasks_of_pod(ctx.pod_type)
            if i.agent_id in ctx.hosts
        }
        if not slices or snapshot.host.slice_id in slices:
            return EvaluationOutcome.ok("same-slice", snapshot.host.slice_id)
        return EvaluationOutcome.fail(
            "same-slice",
            f"pod pinned to slice {sorted(slices)}, host is on "
            f"{snapshot.host.slice_id!r}",
        )

    def candidate_host_ids(self, ctx, index):
        slices = {
            ctx.hosts[i.agent_id].slice_id
            for i in ctx.tasks_of_pod(ctx.pod_type)
            if i.agent_id in ctx.hosts
        }
        if not slices:
            return index.universe()
        value_index = index.value_index("slice")
        out: set = set()
        for s in slices:
            out |= value_index.get(s, frozenset())
        return out


# ---------------------------------------------------------------------------
# Parsers
# ---------------------------------------------------------------------------


def parse_placement(text: str) -> PlacementRule:
    """Parse the YAML ``placement:`` field.

    Two dialects, as in the reference: the marathon-style JSON list
    (MarathonConstraintParser.java) and a colon DSL.  Colon DSL:

        max-per-host:1
        max-per-zone:2
        hostname:exact:h1,h2        hostname:regex:tpu-.*
        zone:exact:us-central2-b    attribute:tier:premium
        task-type:avoid:data        task-type:colocate:data
        group-by:zone               round-robin:zone[:n]
        agent:exact:h1,h2           agent:avoid:h3   (maintenance drain)
        generation:h100             same-slice
        rule1 && rule2              (conjunction)
        rule1 || rule2              (disjunction; binds looser than &&)
    """
    text = (text or "").strip()
    if not text:
        return PassthroughRule()
    if text.startswith("["):
        return _parse_marathon(text)
    alternatives = [a.strip() for a in text.split("||") if a.strip()]
    or_rules: List[PlacementRule] = []
    for alternative in alternatives:
        parts = [p.strip() for p in alternative.split("&&") if p.strip()]
        rules = [_parse_one(p) for p in parts]
        or_rules.append(rules[0] if len(rules) == 1 else AndRule(rules))
    return or_rules[0] if len(or_rules) == 1 else OrRule(or_rules)


_FIELD_ALIASES = {"host": "hostname", "hostname": "hostname", "zone": "zone",
                  "region": "region", "slice": "slice"}


def _parse_one(text: str) -> PlacementRule:
    try:
        return _parse_one_inner(text)
    except (IndexError, KeyError) as e:
        # arity errors surface as parse errors, not crashes — the spec
        # validator turns these into config errors
        raise ValueError(f"malformed placement rule {text!r}: {e}")


def _parse_one_inner(text: str) -> PlacementRule:
    parts = text.split(":")
    head = parts[0].lower()
    if head == "max-per-host":
        return MaxPerRule("hostname", int(parts[1]))
    if head in ("max-per-zone", "max-per-region", "max-per-slice"):
        return MaxPerRule(head.split("-")[-1], int(parts[1]))
    if head == "max-per-attribute":
        return MaxPerRule(parts[1], int(parts[2]))
    if head == "group-by":
        expected = int(parts[2]) if len(parts) > 2 else 0
        return GroupByRule(_FIELD_ALIASES.get(parts[1], parts[1]), expected)
    if head in _FIELD_ALIASES and len(parts) >= 3:
        field_name = _FIELD_ALIASES[head]
        mode, values = parts[1].lower(), parts[2]
        return FieldMatchRule(
            field_name, values.split(","), regex=(mode == "regex")
        )
    if head == "attribute" and len(parts) >= 3:
        return FieldMatchRule(parts[1], [":".join(parts[2:])])
    if head == "generation" and len(parts) == 2:
        return FieldMatchRule("generation", [parts[1]])
    if head == "task-type" and len(parts) == 3:
        return TaskTypeRule(parts[2], colocate=(parts[1].lower() == "colocate"))
    if head == "round-robin" and len(parts) >= 2:
        expected = int(parts[2]) if len(parts) > 2 else 0
        return RoundRobinByRule(
            _FIELD_ALIASES.get(parts[1], parts[1]), expected
        )
    if head == "agent" and len(parts) >= 3:
        mode = parts[1].lower()
        ids = parts[2].split(",")
        if mode in ("exact", "match"):
            return AgentRule(ids)
        if mode == "avoid":
            return AgentRule(ids, avoid=True)
    if head == "same-slice":
        return SameSliceRule()
    raise ValueError(f"unknown placement rule: {text!r}")


def _parse_marathon(text: str) -> PlacementRule:
    """Reference: MarathonConstraintParser.java — JSON like
    [["hostname","UNIQUE"], ["zone","GROUP_BY","3"], ["tier","IS","hot"],
    ["hostname","CLUSTER","h1"], ["zone","LIKE","us-.*"], ["zone","UNLIKE",".."],
    ["hostname","MAX_PER","2"]]."""
    try:
        constraints = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"bad marathon placement JSON: {e}") from e
    if constraints and isinstance(constraints[0], str):
        constraints = [constraints]  # single constraint shorthand
    rules: List[PlacementRule] = []
    for constraint in constraints:
        if not isinstance(constraint, list) or len(constraint) < 2:
            raise ValueError(f"bad marathon constraint: {constraint!r}")
        raw_field, op = constraint[0], constraint[1].upper()
        field_name = _FIELD_ALIASES.get(raw_field, raw_field)
        arg = constraint[2] if len(constraint) > 2 else None
        if op == "UNIQUE":
            rules.append(MaxPerRule(field_name, 1))
        elif op == "MAX_PER":
            rules.append(MaxPerRule(field_name, int(arg)))
        elif op == "GROUP_BY":
            rules.append(GroupByRule(field_name, int(arg) if arg else 0))
        elif op == "IS" or op == "CLUSTER":
            if arg is None:
                raise ValueError(f"{op} requires a value: {constraint!r}")
            rules.append(FieldMatchRule(field_name, [str(arg)]))
        elif op == "LIKE":
            rules.append(FieldMatchRule(field_name, [str(arg)], regex=True))
        elif op == "UNLIKE":
            rules.append(
                FieldMatchRule(field_name, [str(arg)], regex=True, invert=True)
            )
        else:
            raise ValueError(f"unknown marathon operator {op!r}")
    return rules[0] if len(rules) == 1 else AndRule(rules)
