"""Per-package user options schema: the config.json/Cosmos plane (a
copy of ``dcos_commons_tpu/tools/options.py``).

Reference: every reference framework ships a
``universe/config.json`` — a typed schema of operator options with
defaults/enums/constraints (frameworks/helloworld/universe/config.json,
488 lines) — which Cosmos validates user options against and renders
into the scheduler's environment (marathon.json.mustache env block);
the sim harness fakes that pipeline with CosmosRenderer
(sdk/testing/.../CosmosRenderer.java:24).

Here the same plane is an ``options.json`` beside ``svc.yml``::

    {
      "properties": {
        "hello": {
          "description": "hello pod settings",
          "properties": {
            "count": {"type": "integer", "default": 2, "minimum": 1,
                      "env": "HELLO_COUNT"},
            "mode":  {"type": "string", "enum": ["blue", "green"],
                      "default": "blue"}
          }
        }
      }
    }

* every leaf option has a ``type`` (string/integer/number/boolean), an
  optional ``default`` (absent + ``"required": true`` = operator must
  supply), optional ``enum``/``minimum``/``maximum`` constraints, and
  an optional ``env`` name (default: ``SECTION_OPTION`` upper-snaked)
  — the rendered env feeds the YAML's ``{{VAR}}`` interpolation;
* ``render_options(schema, user_options)`` is the Cosmos analogue:
  validate the operator's ``{"section": {"option": value}}`` JSON
  against the schema (unknown keys, wrong types, enum/range
  violations are POINTED errors naming the option) and produce the
  env map;
* ``validate_schema(schema)`` lints the schema itself (package build
  and ``package lint`` refuse a package whose defaults don't satisfy
  their own constraints).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

OPTIONS_FILE = "options.json"

_TYPES = {
    "string": str,
    "boolean": bool,
    "integer": int,
    "number": (int, float),
}


class OptionsError(Exception):
    """User options rejected; ``errors`` lists pointed messages."""

    def __init__(self, errors: List[str]):
        self.errors = list(errors)
        super().__init__("; ".join(self.errors))


def load_schema(framework_dir: str) -> Optional[Dict[str, Any]]:
    """The framework's options.json, or None when it ships none."""
    path = os.path.join(framework_dir, OPTIONS_FILE)
    if not os.path.isfile(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        try:
            schema = json.load(f)
        except ValueError as e:
            raise OptionsError([f"{OPTIONS_FILE} is not valid JSON: {e}"])
    if not isinstance(schema, dict):
        raise OptionsError([
            f"{OPTIONS_FILE} must be a JSON object, "
            f"got {type(schema).__name__}"
        ])
    return schema


def options_findings(framework_dir: str) -> List[str]:
    """Schema findings for one framework dir — the single check both
    ``package build`` and ``package lint`` run (empty = clean or no
    schema shipped)."""
    try:
        schema = load_schema(framework_dir)
    except OptionsError as e:
        return list(e.errors)
    if schema is None:
        return []
    return [
        f"{OPTIONS_FILE}: {finding}" for finding in validate_schema(schema)
    ]


def default_env_name(section: str, option: str) -> str:
    return re.sub(r"[^A-Z0-9]", "_", f"{section}_{option}".upper())


def _iter_options(schema: Dict[str, Any]):
    for section, sect_raw in (schema.get("properties") or {}).items():
        if not isinstance(sect_raw, dict):
            continue  # validate_schema reports it as a finding
        for option, opt_raw in (sect_raw.get("properties") or {}).items():
            yield section, option, (opt_raw or {})


def validate_schema(schema: Dict[str, Any]) -> List[str]:
    """Schema self-consistency findings (empty = clean)."""
    findings: List[str] = []
    if not isinstance(schema, dict) or \
            not isinstance(schema.get("properties"), dict):
        return ["top-level 'properties' object required"]
    for section, sect_raw in schema["properties"].items():
        if not isinstance(sect_raw, dict) or \
                not isinstance(sect_raw.get("properties"), dict):
            # a misspelled/missing 'properties' would otherwise pass
            # lint and then reject every operator option at install
            findings.append(
                f"section {section!r}: needs a 'properties' object"
            )
    seen_env: Dict[str, str] = {}
    for section, option, opt in _iter_options(schema):
        where = f"{section}.{option}"
        opt_type = opt.get("type")
        if opt_type not in _TYPES:
            findings.append(
                f"{where}: type must be one of {sorted(_TYPES)}, "
                f"got {opt_type!r}"
            )
            continue
        default = opt.get("default")
        if default is None and not opt.get("required"):
            findings.append(
                f"{where}: needs a 'default' or \"required\": true"
            )
        if default is not None:
            errors: List[str] = []
            _check_value(section, option, opt, default, errors)
            findings.extend(f"{e} (the schema's own default)"
                            for e in errors)
        env = opt.get("env") or default_env_name(section, option)
        if env in seen_env:
            findings.append(
                f"{where}: env {env!r} collides with {seen_env[env]}"
            )
        seen_env[env] = where
        if "minimum" in opt and "maximum" in opt and \
                opt["minimum"] > opt["maximum"]:
            findings.append(f"{where}: minimum > maximum")
    return findings


def _check_value(
    section: str, option: str, opt: Dict[str, Any], value: Any,
    errors: List[str],
) -> None:
    where = f"{section}.{option}"
    expected = _TYPES[opt["type"]]
    # bool is an int subclass: reject True for integer/number options
    if isinstance(value, bool) and opt["type"] != "boolean":
        errors.append(
            f"{where}: expected {opt['type']}, got boolean {value!r}"
        )
        return
    if not isinstance(value, expected):
        errors.append(
            f"{where}: expected {opt['type']}, "
            f"got {type(value).__name__} {value!r}"
        )
        return
    enum = opt.get("enum")
    if enum and value not in enum:
        errors.append(f"{where}: {value!r} not one of {enum}")
    try:
        if "minimum" in opt and value < opt["minimum"]:
            errors.append(
                f"{where}: {value!r} below minimum {opt['minimum']}"
            )
        if "maximum" in opt and value > opt["maximum"]:
            errors.append(
                f"{where}: {value!r} above maximum {opt['maximum']}"
            )
    except TypeError:
        # the CONSTRAINT doesn't fit the type (e.g. minimum on a
        # string): a schema bug, reported as a finding not a crash
        errors.append(
            f"{where}: minimum/maximum not comparable with "
            f"{opt['type']} values"
        )


def _render_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


def render_options(
    schema: Optional[Dict[str, Any]],
    user_options: Optional[Dict[str, Any]],
) -> Dict[str, str]:
    """The Cosmos render: defaults overlaid with the operator's
    options, validated, flattened to the env map the YAML interpolates.

    Raises OptionsError with every violation (not just the first) so
    the operator fixes the options file in one pass."""
    user_options = user_options or {}
    if schema is None:
        if user_options:
            raise OptionsError([
                "this package ships no options.json; options "
                f"{sorted(user_options)} cannot be applied"
            ])
        return {}
    errors: List[str] = []
    known = {
        (section, option): opt
        for section, option, opt in _iter_options(schema)
    }
    known_by_section: Dict[str, List[str]] = {}
    for section, option in known:
        known_by_section.setdefault(section, []).append(option)
    # unknown keys are pointed errors (a typo must not silently fall
    # back to the default)
    for section, sect_value in user_options.items():
        if section not in known_by_section:
            errors.append(
                f"no such options section {section!r}; known: "
                f"{sorted(known_by_section)}"
            )
            continue
        if not isinstance(sect_value, dict):
            errors.append(f"options section {section!r} must be an object")
            continue
        for option in sect_value:
            if (section, option) not in known:
                errors.append(
                    f"no such option {section}.{option}; known: "
                    + ", ".join(
                        f"{section}.{o}"
                        for o in sorted(known_by_section[section])
                    )
                )
    env: Dict[str, str] = {}
    for (section, option), opt in sorted(known.items()):
        provided = user_options.get(section, {})
        if isinstance(provided, dict) and option in provided:
            value = provided[option]
            _check_value(section, option, opt, value, errors)
        elif "default" in opt:
            value = opt["default"]
        else:  # required, not provided
            errors.append(
                f"{section}.{option} is required and has no default"
            )
            continue
        env[opt.get("env") or default_env_name(section, option)] = \
            _render_value(value)
    if errors:
        raise OptionsError(errors)
    return env


def prune_unknown(
    schema: Optional[Dict[str, Any]],
    options: Optional[Dict[str, Any]],
) -> tuple:
    """(kept, dropped) — options the schema still defines vs ones it
    no longer knows.  Used on PRIOR (stored) options at upgrade time:
    a new package version that drops an option must not be blocked
    forever by the stored value (the strict unknown-key rejection
    stays for freshly-PASSED options, where unknown = typo)."""
    options = options or {}
    if schema is None:
        return {}, sorted(
            f"{s}.{o}" for s, v in options.items()
            for o in (v if isinstance(v, dict) else {""})
        )
    known = {
        (section, option)
        for section, option, _ in _iter_options(schema)
    }
    kept: Dict[str, Any] = {}
    dropped: List[str] = []
    for section, sect_value in options.items():
        if not isinstance(sect_value, dict):
            dropped.append(section)
            continue
        for option, value in sect_value.items():
            if (section, option) in known:
                kept.setdefault(section, {})[option] = value
            else:
                dropped.append(f"{section}.{option}")
    return kept, sorted(dropped)


def merge_options(
    base: Optional[Dict[str, Any]],
    override: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    """Per-section merge for upgrades: Cosmos `update` keeps prior
    options and overlays the newly-passed ones."""
    out: Dict[str, Any] = {
        k: dict(v) if isinstance(v, dict) else v
        for k, v in (base or {}).items()
    }
    for section, sect_value in (override or {}).items():
        if isinstance(sect_value, dict) and \
                isinstance(out.get(section), dict):
            out[section].update(sect_value)
        else:
            out[section] = sect_value
    return out
