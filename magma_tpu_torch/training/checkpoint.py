"""Training checkpoints: params, batch-norm state, optimizer state and step.

Port of ``magma_tpu/training/checkpoint.py`` with ``torch.save`` in place
of Orbax, in the same layout (reference magma/utils.py:89-117):

    {save_dir}/step_{n}/checkpoint.pt  -- {"params", "state", "opt_state"}
    {save_dir}/latest                  -- names the newest step dir, written last
    {save_dir}/config.yml              -- the config dump

Tensors are saved from the CPU; a load puts each one back on the device
and in the dtype of the template it restores.  ``restore_params`` is the
inference-time restore (params and batch statistics, no optimizer state)
that ``Magma.from_checkpoint`` runs on a directory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

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


def _like(template, restored):
    """``restored`` on the devices and in the dtypes of ``template``'s
    tensors (other leaves as restored)."""
    def leaf(t, r):
        if isinstance(t, torch.Tensor):
            return r.to(device=t.device, dtype=t.dtype)
        return r

    return tree_map(leaf, template, restored)


def load_checkpoint(load_dir: str, params_template: Dict, state_template: Optional[Dict] = None,
                    opt_state_template: Any = None
                    ) -> Tuple[Optional[Dict], Optional[Dict], Any, int]:
    """Restore (params, state, opt_state, global_step); (None, None, None, 0)
    when nothing restorable exists, and the caller starts from scratch
    (utils.py:105-117)."""
    step_dir = latest_step_dir(load_dir)
    if step_dir is None:
        print(f"Model loading failed from {load_dir} - starting from global step 0")
        return None, None, None, 0
    restored = torch.load(step_dir / CKPT_FILE, map_location="cpu", weights_only=True)
    params = _like(params_template, restored["params"])
    state = (_like(state_template, restored["state"])
             if state_template is not None and "state" in restored else None)
    opt_state = (_like(opt_state_template, restored["opt_state"])
                 if opt_state_template is not None and "opt_state" in restored else None)
    return params, state, opt_state, int(step_dir.name.split("_")[-1])


def _copy_into(template, restored, path: str) -> None:
    """Copy ``restored`` into ``template``'s tensors in place, each keeping
    its device and dtype: one copy of a tensor exists on the device, never
    two.  The trees must match key for key and shape for shape."""
    if isinstance(template, dict):
        if not isinstance(restored, dict) or restored.keys() != template.keys():
            got = sorted(restored) if isinstance(restored, dict) else type(restored).__name__
            raise ValueError(f"checkpoint {path or 'root'}: keys {got}, the model has "
                             f"{sorted(template)}")
        for k, v in template.items():
            _copy_into(v, restored[k], f"{path}/{k}")
    elif isinstance(template, (list, tuple)):
        if not isinstance(restored, (list, tuple)) or len(restored) != len(template):
            raise ValueError(f"checkpoint {path}: not a list of {len(template)}")
        for i, v in enumerate(template):
            _copy_into(v, restored[i], f"{path}/{i}")
    elif isinstance(template, torch.Tensor):
        if not isinstance(restored, torch.Tensor) or restored.shape != template.shape:
            got = tuple(restored.shape) if isinstance(restored, torch.Tensor) else restored
            raise ValueError(f"checkpoint {path}: {got}, the model has {tuple(template.shape)}")
        template.copy_(restored)


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
    # mmap: each tensor is read from the file as it is copied
    restored = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    with torch.no_grad():
        _copy_into(params_template, restored["params"], "params")
        if state_template is not None and "state" in restored:
            _copy_into(state_template, restored["state"], "state")
    return params_template, state_template
