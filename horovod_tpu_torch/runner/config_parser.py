"""YAML config-file layer for the launcher.

A copy of the JAX package's ``runner/config_parser.py``. Parity:
``horovod/runner/common/util/config_parser.py`` + ``--config-file``
(``launch.py:293-296``) -- the third configuration layer (env vars <
config file < explicit CLI flags).

The reference's YAML schema is kept::

    verbose: true
    params:
      fusion-threshold-mb: 64
      cycle-time-ms: 2.5
      cache-capacity: 2048
    autotune:
      enabled: true
      log-file: autotune.csv
    timeline:
      filename: timeline.json
      mark-cycles: true
    stall-check:
      enabled: false
      warning-time-seconds: 120
    elastic:
      min-np: 2
      max-np: 8
      reset-limit: 3

Flat top-level keys matching argument names (``num-proc: 8``) also work.
Values set explicitly on the command line always win over the file.
``yaml`` is imported inside :func:`read_config_file`: only a launch with a
config file needs it.
"""

from __future__ import annotations

from typing import Any, Dict

# (yaml section, yaml key) -> argparse dest
_SCHEMA = {
    ("", "num-proc"): "num_proc",
    ("", "hosts"): "hosts",
    ("", "hostfile"): "hostfile",
    ("", "verbose"): "verbose",
    ("params", "fusion-threshold-mb"): "fusion_threshold_mb",
    ("params", "cycle-time-ms"): "cycle_time_ms",
    ("params", "cache-capacity"): "cache_capacity",
    ("autotune", "enabled"): "autotune",
    ("autotune", "log-file"): "autotune_log_file",
    ("timeline", "filename"): "timeline_filename",
    ("timeline", "mark-cycles"): "timeline_mark_cycles",
    ("stall-check", "warning-time-seconds"): "stall_warning_time_seconds",
    ("elastic", "min-np"): "min_np",
    ("elastic", "max-np"): "max_np",
    ("elastic", "host-discovery-script"): "host_discovery_script",
    ("elastic", "reset-limit"): "reset_limit",
}


_SECTIONS = {s for s, _ in _SCHEMA if s}
_FLAT_KEYS = {k for s, k in _SCHEMA if not s}


def read_config_file(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    if not isinstance(doc, dict):
        raise ValueError(f"config file {path} must be a YAML mapping")

    known_by_section: Dict[str, set] = {}
    for section, key in _SCHEMA:
        known_by_section.setdefault(section, set()).add(key)
    known_by_section.setdefault("stall-check", set()).add("enabled")

    unknown = []
    for key, value in doc.items():
        if key in _SECTIONS:
            if value is None:
                continue  # 'params:' with all keys commented out
            if not isinstance(value, dict):
                raise ValueError(
                    f"config section {key!r} must be a mapping"
                )
            unknown += [
                f"{key}.{sub}"
                for sub in value
                if sub not in known_by_section.get(key, ())
            ]
        elif key not in _FLAT_KEYS:
            unknown.append(key)
    if unknown:
        raise ValueError(
            f"unrecognized config key(s) in {path}: {', '.join(unknown)}"
        )

    values: Dict[str, Any] = {}
    for (section, key), dest in _SCHEMA.items():
        src = doc.get(section, {}) if section else doc
        if isinstance(src, dict) and key in src:
            values[dest] = src[key]
    # stall-check.enabled: false -> the --no-stall-check flag.
    stall = doc.get("stall-check")
    if isinstance(stall, dict) and stall.get("enabled") is False:
        values["no_stall_check"] = True
    return values


def apply_config_file(args, parser) -> None:
    """Overlay config-file values onto parsed args, in place.

    Only fills slots the user did not set explicitly: a value is applied
    when the current arg equals the parser's default for that dest
    (reference ``config_parser.set_args_from_config`` semantics). Values
    are coerced through the matching argparse ``type`` so quoted YAML
    numbers behave like CLI strings.
    """
    values = read_config_file(args.config_file)
    types = {
        a.dest: a.type for a in parser._actions if a.type is not None
    }
    for dest, value in values.items():
        if not hasattr(args, dest):
            continue
        if getattr(args, dest) == parser.get_default(dest):
            coerce = types.get(dest)
            if coerce is not None and value is not None:
                value = coerce(value)
            setattr(args, dest, value)
