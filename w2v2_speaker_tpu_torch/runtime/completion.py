"""Shell completion of the run and predict twins (``-sc``).

Counterpart of ``w2v2_speaker_tpu/runtime/completion.py`` for the module
invocation of the port:

    eval "$(python -m w2v2_speaker_tpu_torch.run -sc install=bash)"

registers a bash function that asks
``python -m w2v2_speaker_tpu_torch.{run,predict} -sc query=<word>`` for
candidates:

- config-group swaps found in the config directory (``network=``,
  ``optim.loss=``, ``trainer=``, ``hydra/launcher=``, ...), with their
  option names as values,
- the ``+experiment=`` and ``+search=`` presets,
- dotted value overrides from the composed default config
  (``trainer.max_steps=``, ``data.module.data_dir=``, ...).
"""

from __future__ import annotations

import pathlib
import sys
from typing import Dict, List, Tuple

__all__ = ["candidates", "discover_groups", "handle_shell_completion"]

_PLUS_GROUPS = ("experiment", "search")  # composed with a leading '+'
PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]


def discover_groups(config_dir: pathlib.Path) -> Dict[str, Tuple[str, List[str]]]:
    """Each config group's "/"-joined directory path -> (its command-line
    spelling, sorted option names); the spelling is dotted
    (``optim.loss``) except for the ``hydra/*`` groups
    (``hydra/launcher``)."""
    groups: Dict[str, Tuple[str, List[str]]] = {}
    for d in sorted(p for p in config_dir.rglob("*") if p.is_dir()):
        opts = sorted(f.stem for f in d.glob("*.yaml"))
        if not opts:
            continue
        rel = d.relative_to(config_dir).parts
        norm = "/".join(rel)
        groups[norm] = (norm if rel[0] == "hydra" else ".".join(rel), opts)
    return groups


def _leaf_paths(tree: Dict, prefix: str = "") -> List[str]:
    out: List[str] = []
    for k, v in tree.items():
        if str(k).startswith("__"):
            continue  # composition markers
        p = f"{prefix}{k}"
        if isinstance(v, dict) and v:
            out.extend(_leaf_paths(v, p + "."))
        else:
            out.append(p)
    return out


def candidates(config_dir: pathlib.Path, word: str, entry: str = "train_eval") -> List[str]:
    """Completion candidates for the partial override ``word``."""
    groups = discover_groups(config_dir)
    if "=" in word:  # the option of a group swap or preset
        key, _, prefix = word.partition("=")
        norm = key.strip().lstrip("+").replace(".", "/")
        if norm in groups:
            return [f"{key}={o}" for o in groups[norm][1] if o.startswith(prefix)]
        return []
    cands = {f"{'+' if norm in _PLUS_GROUPS else ''}{display}=" for norm, (display, _) in groups.items()}
    from .config import load_config

    try:  # key paths only: the ${...} templates stay unresolved
        cands.update(p + "=" for p in _leaf_paths(load_config(config_dir, entry, [], resolve_interpolations=False)))
    except Exception:
        pass  # a broken tree still completes group names
    return sorted(c for c in cands if c.startswith(word))


_BASH_TEMPLATE = """\
# bash completion for python -m {module} (and its run/predict twin). Install with:
#   eval "$(python -m {module} -sc install=bash)"
_w2v2_torch_sc() {{
  local line cur prefix
  case "${{COMP_WORDS[1]:-}} ${{COMP_WORDS[2]:-}}" in
    "-m {package}.run"|"-m {package}.predict") ;;
    *) COMPREPLY=(); return 0 ;;
  esac
  # bash splits words at '=': recover the whole current word from COMP_LINE
  line="${{COMP_LINE:0:COMP_POINT}}"
  cur="${{line##* }}"
  prefix=""
  case "$cur" in *=*) prefix="${{cur%=*}}=" ;; esac
  local IFS=$'\\n'
  COMPREPLY=( $(PYTHONPATH="{root}" "{python}" -m "${{COMP_WORDS[2]}}" -sc "query=$cur" 2>/dev/null) )
  COMPREPLY=( "${{COMPREPLY[@]#"$prefix"}}" )
}}
complete -o nospace -o default -F _w2v2_torch_sc python python3
"""


def handle_shell_completion(config_dir: pathlib.Path, args: List[str], entry: str = "train_eval",
                            module: str = "w2v2_speaker_tpu_torch.run") -> None:
    """``-sc install=bash`` prints the completion script to eval;
    ``-sc query=<word>`` prints the candidates, one per line."""
    key, _, val = (args[0] if args else "").partition("=")
    if key == "install":
        if val != "bash":
            raise SystemExit(f"unsupported completion shell {val!r}")
        print(_BASH_TEMPLATE.format(module=module, package=module.rpartition(".")[0], root=PACKAGE_ROOT,
                                    python=sys.executable))
    elif key == "query":
        for c in candidates(config_dir, val, entry=entry):
            print(c)
    else:
        raise SystemExit("usage: -sc install=bash | -sc query=<partial-override>")
