"""Hydra-grammar configuration on plain dicts (copy of
``w2v2_speaker_tpu/runtime/config.py``).

The same surface as the JAX package's loader: a defaults list composing
config groups, ``# @package _global_`` experiment presets applying
``override /group: option`` entries, dotted ``key=value`` overrides,
``+experiment=name`` appends, group swaps (``network=wav2vec2_fc``),
``${...}`` interpolation with the ``divide`` / ``idivide`` /
``random_uuid`` resolvers and ``${oc.env:VAR}`` (``load_config`` :276,
``apply_overrides`` :213, ``resolve`` :183, the resolvers :139-181). Files
are read with PyYAML's ``safe_load``, as the JAX package reads them.
``tests/test_torch_config.py`` holds it against the JAX package's loader
on every experiment and on ``predict``.
"""

from __future__ import annotations

import copy
import os
import pathlib
import re
import uuid
from typing import Any, Dict, List, Optional, Sequence

import yaml

__all__ = ["load_config", "apply_overrides", "resolve", "ConfigError"]


class ConfigError(ValueError):
    pass


# ------------------------------------------------------------------ helpers

def _read_yaml(path: pathlib.Path) -> Dict:
    if not path.exists():
        raise ConfigError(f"config file not found: {path}")
    text = path.read_text()
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"{path} must contain a mapping")
    data["__global_package__"] = "@package _global_" in text.splitlines()[0] if text else False
    return data


def _deep_merge(base: Dict, extra: Dict) -> Dict:
    out = dict(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(cfg: Dict, dotted: str, value: Any) -> None:
    node = cfg
    parts = dotted.replace("/", ".").split(".")
    for i, p in enumerate(parts[:-1]):
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            # tolerate scalar->mapping promotion (e.g. hydra/launcher=slurm
            # followed by hydra.launcher.x=y: launcher passthrough keys)
            nxt = {}
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


def _get_path(cfg: Dict, dotted: str) -> Any:
    node = cfg
    for p in dotted.replace("/", ".").split("."):
        if not isinstance(node, dict) or p not in node:
            raise ConfigError(f"no such config key: {dotted}")
        node = node[p]
    return node


_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _parse_value(text: str) -> Any:
    value = yaml.safe_load(text)
    # YAML 1.1 only accepts scientific notation with a dot ('3.0e-3');
    # accept the CLI-friendly '3e-3' too
    if isinstance(value, str) and _FLOAT_RE.match(value.strip()):
        return float(value)
    return value


# ------------------------------------------------------------ group loading

def _load_group(
    config_dir: pathlib.Path, group: str, option: str
) -> tuple:
    """-> (content, is_global_package). A group file marked
    `# @package _global_` merges into the config root instead of its group
    node (Hydra semantics) — used by presets that bundle settings across
    groups, e.g. pairs/triplets module presets also fixing shard knobs
    (reference voxceleb1_pairs.yaml:41-42)."""
    path = config_dir / group / f"{option}.yaml"
    data = _read_yaml(path)
    is_global = bool(data.pop("__global_package__", False))
    data.pop("defaults", None)
    return data, is_global


def _apply_defaults(
    cfg: Dict,
    defaults: Sequence,
    config_dir: pathlib.Path,
    group_choices: Dict[str, str],
) -> None:
    for entry in defaults:
        if entry == "_self_":
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ConfigError(f"unsupported defaults entry: {entry!r}")
        (group, option), = entry.items()
        group = str(group)
        is_override = group.startswith("override ")
        if is_override:
            group = group[len("override "):]
        group = group.lstrip("/")
        if option is None:
            continue
        group_choices[group] = str(option)
        loaded, is_global = _load_group(config_dir, group, str(option))
        if is_global:
            cfg.update(_deep_merge(cfg, loaded))
        else:
            _set_path(cfg, group, loaded)


# ------------------------------------------------------------- interpolation

_INTERP = re.compile(r"\$\{([^${}]+)\}")


def _resolve_expr(expr: str, root: Dict) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        rest = expr[len("oc.env:"):]
        parts = rest.split(",", 1)
        var = parts[0].strip()
        if var in os.environ:
            return os.environ[var]
        if len(parts) == 2:
            return _parse_value(parts[1].strip())
        raise ConfigError(f"environment variable {var} not set")
    if expr.startswith("divide:"):
        a, b = (
            _resolve_scalar(x.strip(), root)
            for x in expr[len("divide:"):].split(",")
        )
        return float(a) / float(b)
    if expr.startswith("idivide:"):
        a, b = (
            _resolve_scalar(x.strip(), root)
            for x in expr[len("idivide:"):].split(",")
        )
        return int(float(a) // float(b))
    if expr.startswith("random_uuid:") or expr == "random_uuid":
        # ONE uuid per compose (seeded by load_config): Hydra resolves its
        # run dir (and therefore ${experiment_name}) once per job, so every
        # interpolation site — experiment_name, checkpoint_dir, log_dir —
        # must agree on the same value or checkpoints and TB events land
        # in unrelated experiment dirs. Read-only here: inserting into
        # `root` mid-resolve would mutate a dict being iterated.
        return root.get("__random_uuid__") or str(uuid.uuid4())
    # plain key reference
    return resolve(_get_path(root, expr), root)


def _resolve_scalar(token: str, root: Dict) -> Any:
    value = _parse_value(token)
    if isinstance(value, str):
        return _resolve_expr(value, root) if not _INTERP.search(value) else resolve(value, root)
    if isinstance(value, (int, float)):
        return value
    return _resolve_expr(token, root)


def resolve(value: Any, root: Dict) -> Any:
    """Recursively resolve ${...} interpolations against the root config."""
    if isinstance(value, dict):
        return {k: resolve(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve(v, root) for v in value]
    if isinstance(value, str):
        # iterate: inner interpolations resolve first, enabling nesting like
        # ${divide:${a},${b}}
        for _ in range(10):
            full = _INTERP.fullmatch(value.strip())
            if full:
                resolved = _resolve_expr(full.group(1), root)
                if not isinstance(resolved, str):
                    return resolved
                value = resolved
                continue
            if not _INTERP.search(value):
                break

            def sub(m):
                return str(_resolve_expr(m.group(1), root))

            value = _INTERP.sub(sub, value)
        return value
    return value


# ------------------------------------------------------------------ overrides

def apply_overrides(
    cfg: Dict,
    overrides: Sequence[str],
    config_dir: pathlib.Path,
    group_choices: Dict[str, str],
) -> Dict:
    """Hydra grammar: `key=value` dotted sets, `group=option` group swaps,
    `+experiment=name` global-package preset application.

    Like Hydra, group-level composition (experiment presets and group swaps)
    happens first and plain `key=value` overrides apply afterwards, so a CLI
    value always wins over anything a preset re-loads."""
    group_phase, value_phase = [], []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override '{ov}' is not key=value")
        key = ov.partition("=")[0].strip().lstrip("+")
        norm = key.replace(".", "/")
        if norm == "experiment" or (config_dir / norm).is_dir():
            group_phase.append(ov)
        else:
            value_phase.append(ov)

    for ov in group_phase + value_phase:
        key, _, raw = ov.partition("=")
        key = key.strip()
        additive = key.startswith("+")
        if additive:
            key = key[1:]
        norm = key.replace(".", "/")

        # experiment / search preset (global package)
        if norm in ("experiment", "search"):
            preset = _read_yaml(config_dir / norm / f"{raw}.yaml")
            is_global = preset.pop("__global_package__", False)
            defaults = preset.pop("defaults", [])
            _apply_defaults(cfg, defaults, config_dir, group_choices)
            if not is_global:
                raise ConfigError(
                    f"{norm}/{raw}.yaml must be '# @package _global_'"
                )
            cfg = _deep_merge(cfg, preset)
            cfg.setdefault(norm, {})
            if norm == "experiment":
                cfg.setdefault("experiment_preset", raw)
            continue

        # group swap: the key names a config group directory
        if (config_dir / norm).is_dir():
            loaded, is_global = _load_group(config_dir, norm, raw.strip())
            group_choices[norm] = raw.strip()
            if is_global:
                cfg = _deep_merge(cfg, loaded)
            else:
                _set_path(cfg, norm, loaded)
            continue

        _set_path(cfg, key, _parse_value(raw))
    return cfg


# ------------------------------------------------------------------ entry

def load_config(
    config_dir: pathlib.Path | str,
    config_name: str = "train_eval",
    overrides: Optional[Sequence[str]] = None,
    resolve_interpolations: bool = True,
) -> Dict:
    """Compose `<config_dir>/<config_name>.yaml` with its defaults list,
    apply CLI overrides, resolve interpolations.

    `resolve_interpolations=False` returns the composed tree with `${...}`
    strings intact — used by launchers that must forward values for the
    *launched* process to resolve (e.g. per-array-task `${random_uuid:}`
    experiment names, run.py SLURM path)."""
    config_dir = pathlib.Path(config_dir)
    root_file = _read_yaml(config_dir / f"{config_name}.yaml")
    root_file.pop("__global_package__", None)
    defaults = root_file.pop("defaults", [])

    cfg: Dict = {}
    group_choices: Dict[str, str] = {}
    _apply_defaults(cfg, defaults, config_dir, group_choices)
    cfg = _deep_merge(cfg, root_file)
    cfg = apply_overrides(cfg, overrides or [], config_dir, group_choices)
    cfg["__groups__"] = dict(group_choices)
    if not resolve_interpolations:
        return cfg
    cfg["__random_uuid__"] = str(uuid.uuid4())  # one uuid per compose
    resolved = resolve(cfg, cfg)
    resolved.pop("__random_uuid__", None)
    return resolved
