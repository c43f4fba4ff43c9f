"""Training checkpoints: params, batch-norm state, optimizer state and step.

Port of ``magma_tpu/training/checkpoint.py`` with ``torch.save`` in place
of Orbax, in the same layout (reference magma/utils.py:89-117):

    {save_dir}/step_{n}/checkpoint.pt  -- {"params", "state", "opt_state"}
    {save_dir}/latest                  -- names the newest step dir, written last
    {save_dir}/config.yml              -- the config dump

Tensors are saved from the CPU.  Both loads, ``load_checkpoint`` (the
Trainer's resume: params, state and optimizer state) and ``restore_params``
(the inference-time restore of params and batch statistics that
``Magma.from_checkpoint`` runs on a directory), check the file against
their templates key for key and shape for shape and copy each tensor into
the template's in place, on its device and in its dtype.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
import yaml

from magma_tpu_torch.utils import tree_map

CKPT_FILE = "checkpoint.pt"


def _yaml_plain(x):
    """The config as plain YAML values; anything else (a torch dtype in the
    encoder overrides) by its str()."""
    if isinstance(x, dict):
        return {k: _yaml_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_yaml_plain(v) for v in x]
    return x if x is None or isinstance(x, (str, int, float, bool)) else str(x)


def save_checkpoint(save_dir: str, global_step: int, params: Dict, state: Optional[Dict] = None,
                    opt_state: Any = None, config=None) -> str:
    """Save a full training checkpoint; the ``latest`` tag is written last,
    so a crash mid-save never corrupts a resume."""
    save_dir = Path(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    if config is not None:
        with open(save_dir / "config.yml", "w") as f:
            yaml.safe_dump(_yaml_plain(config.to_dict()), f, default_flow_style=False)
    step_dir = (save_dir / f"step_{global_step}").absolute()
    os.makedirs(step_dir, exist_ok=True)
    payload = {"params": params}
    if state is not None:
        payload["state"] = state
    if opt_state is not None:
        payload["opt_state"] = opt_state
    torch.save(tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                        payload), step_dir / CKPT_FILE)
    with open(save_dir / "latest", "w") as f:
        f.write(f"step_{global_step}")
    return str(step_dir)


def latest_step_dir(save_dir: str) -> Optional[Path]:
    tag = Path(save_dir) / "latest"
    if not tag.exists():
        return None
    step_dir = Path(save_dir) / tag.read_text().strip()
    return step_dir if (step_dir / CKPT_FILE).exists() else None


def _match(template, restored, path: str, pairs: List) -> Any:
    """Check ``restored`` against ``template`` key for key and shape for
    shape, appending each (template tensor, restored tensor) to ``pairs``.
    Returns the template's tree with its other leaves (the optimizer's
    counts) as restored.  A leaf that differs raises a ``ValueError`` that
    names it."""
    if isinstance(template, dict):
        if not isinstance(restored, dict):
            raise ValueError(f"checkpoint {path}: a {type(restored).__name__}, the model has "
                             f"keys {sorted(template)}")
        extra = sorted(restored.keys() - template.keys())
        missing = sorted(template.keys() - restored.keys())
        if extra or missing:
            raise ValueError("; ".join([f"checkpoint {path}/{k}: not in the model" for k in extra]
                                       + [f"checkpoint {path}/{k}: not in the file"
                                          for k in missing]))
        return {k: _match(v, restored[k], f"{path}/{k}", pairs) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(restored, (list, tuple)) or len(restored) != len(template):
            raise ValueError(f"checkpoint {path}: not a list of {len(template)}")
        return [_match(v, restored[i], f"{path}/{i}", pairs) for i, v in enumerate(template)]
    if isinstance(template, torch.Tensor):
        if not isinstance(restored, torch.Tensor) or restored.shape != template.shape:
            got = tuple(restored.shape) if isinstance(restored, torch.Tensor) else restored
            raise ValueError(f"checkpoint {path}: {got}, the model has {tuple(template.shape)}")
        pairs.append((template, restored))
        return template
    if isinstance(restored, torch.Tensor):
        raise ValueError(f"checkpoint {path}: a tensor, the model has {template!r}")
    return restored


def _restore(path: Path, templates: Dict[str, Any]) -> Dict:
    """Read ``path`` and copy its trees into ``templates`` (name -> tree, the
    trees None or absent from the file skipped) in place, each tensor
    keeping its device and dtype: one copy of a tensor exists on the
    device, never two.  Every tree is checked before the first copy, so a
    checkpoint that does not match leaves the templates as they were.
    Returns {name: restored tree}."""
    # mmap: each tensor is read from the file as it is copied
    payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "params" not in payload:
        raise ValueError(f"checkpoint {path}: no params")
    pairs: List = []
    out = {name: _match(t, payload[name], name, pairs) for name, t in templates.items()
           if t is not None and name in payload}
    with torch.no_grad():
        for t, r in pairs:
            t.copy_(r)
    return out


def load_checkpoint(load_dir: str, params_template: Dict, state_template: Optional[Dict] = None,
                    opt_state_template: Any = None
                    ) -> Tuple[Optional[Dict], Optional[Dict], Any, int]:
    """Restore (params, state, opt_state, global_step) into the templates in
    place (``_restore``: a key or a shape that differs raises); (None, None,
    None, 0) when nothing restorable exists, and the caller starts from
    scratch (utils.py:105-117).  A tree the file lacks comes back None."""
    step_dir = latest_step_dir(load_dir)
    if step_dir is None:
        print(f"Model loading failed from {load_dir} - starting from global step 0")
        return None, None, None, 0
    out = _restore(step_dir / CKPT_FILE, {"params": params_template, "state": state_template,
                                         "opt_state": opt_state_template})
    return (out["params"], out.get("state"), out.get("opt_state"),
            int(step_dir.name.split("_")[-1]))


def restore_params(ckpt_dir: str, params_template: Dict, state_template: Optional[Dict]
                   ) -> Tuple[Dict, Optional[Dict]]:
    """Inference-time restore of (params, state) (``checkpoint.py:105-126``):
    ``ckpt_dir`` is a save root (its ``latest`` names the step) or a step
    directory; the port's own ``checkpoint.pt`` is read (never Orbax).  The
    restored tensors are copied into the templates' tensors in place, which
    are returned.  A checkpoint without "state" keeps ``state_template``.
    A key or a shape that differs from the template raises, and so does a
    file that does not load."""
    step_dir = latest_step_dir(ckpt_dir) or Path(ckpt_dir)
    path = step_dir / CKPT_FILE
    if not path.is_file():
        raise FileNotFoundError(f"no {CKPT_FILE} in {ckpt_dir} or under the step its "
                                f"'latest' names")
    _restore(path, {"params": params_template, "state": state_template})
    return params_template, state_template
