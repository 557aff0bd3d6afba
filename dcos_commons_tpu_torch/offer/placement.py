"""Placement rules, the parsing half (port of
``dcos_commons_tpu/offer/placement.py``): ``parse_placement`` turns the
YAML ``placement:`` field into a tree of rules, so that the spec
validators (``specification/validation.py``) can refuse a string that
does not parse and see which fields a rule reads.

The rules here are the reference's classes with their constructors and
fields, line for line; how they filter hosts and bound candidate sets
belongs to the offer engine, which the port does not have yet (its
placement unit will be the 8-GPU NVLink node where the reference's is
the TPU host on an ICI torus).

Reference: offer/evaluate/placement/ (38 classes, SURVEY.md section
2.1): And/Or/Not combinators, Hostname/Attribute/Region/ZoneRule,
TaskTypeRule colocate/avoid, MaxPerHostname/Zone/Region/Attribute,
RoundRobinByHostname/Zone, string matchers Exact/Regex/Any, and
MarathonConstraintParser for the JSON dialect
(`[["hostname", "UNIQUE"]]`, GROUP_BY, CLUSTER, LIKE/UNLIKE, MAX_PER,
IS) accepted in the YAML ``placement:`` field.
"""

from __future__ import annotations

import json
from typing import List, Sequence


class PlacementRule:
    """A node of the parsed rule tree."""


class PassthroughRule(PlacementRule):
    pass


class AndRule(PlacementRule):
    def __init__(self, rules: Sequence[PlacementRule]):
        self.rules = list(rules)


class OrRule(PlacementRule):
    def __init__(self, rules: Sequence[PlacementRule]):
        self.rules = list(rules)


class NotRule(PlacementRule):
    def __init__(self, rule: PlacementRule):
        self.rule = rule


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


class MaxPerRule(PlacementRule):
    """At most N instances of this pod per distinct field value.

    Reference: MaxPerHostnameRule / MaxPerZoneRule / etc.
    """

    def __init__(self, field_name: str, max_count: int):
        self.field_name = field_name
        self.max_count = max_count


class GroupByRule(PlacementRule):
    def __init__(self, field_name: str, expected_values: int = 0):
        self.field_name = field_name
        self.expected_values = expected_values


class TaskTypeRule(PlacementRule):
    def __init__(self, other_pod_type: str, colocate: bool):
        self.other = other_pod_type
        self.colocate = colocate


class AgentRule(PlacementRule):
    def __init__(self, host_ids: List[str], avoid: bool = False):
        self.host_ids = set(host_ids)
        self.avoid = avoid


class RoundRobinByRule(PlacementRule):
    def __init__(self, field_name: str, expected_values: int = 0):
        self.field_name = field_name
        self.expected_values = expected_values


class SameSliceRule(PlacementRule):
    """All instances of the pod on one slice (host group)."""


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
