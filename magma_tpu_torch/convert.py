"""Weights into the port: reference-named torch state dicts, and the JAX
package's parameter tree.

``convert_state_dict`` follows ``magma_tpu/training/torch_convert.py``
(``convert_state_dict`` and ``_lm_from_torch``) for the published
checkpoint's names (``mp_rank_00_model_states.pt``, ``sd["module"]``):

    lm.transformer.wte.weight                        (50258, 4096)
    lm.transformer.h.{i}.ln_1.{weight,bias}
    lm.transformer.h.{i}.attn[.attn_block|.module].attention.{q,k,v,out}_proj...
    lm.transformer.h.{i}.mlp[.0].c_fc / c_proj       (.0 with an mlp adapter)
    lm.transformer.h.{i}.mlp.1.adapter.{j}...        (mlp adapter)
    lm.transformer.h.{i}.attn.adapter.{j}...         (attention adapter)
    lm.transformer.h.{i}.attn.adapter_scale          (scaled_parallel)
    lm.transformer.ln_f.{weight,bias}
    image_prefix.proj / image_prefix.ln / image_prefix.enc.<tower names>

The tower's names: the CLIP ResNets' as the checkpoint has them, the CLIP
ViT-B/32's as OpenAI's ``VisionTransformer`` (``conv1``,
``class_embedding``, ``transformer.resblocks.{i}.attn.in_proj_weight``
[q; k; v], ...), NF-ResNet50's as timm's ``NormFreeNet`` (``stem.conv``,
``stages.{s}.{b}.conv{1,2,3}`` with their ``gain``, ``downsample.conv``).
``convert_encoder_state_dict`` and ``load_pretrained_encoder`` take a
tower's checkpoint alone.

Conversions: Linear (out, in) -> kernel (in, out); per-layer tensors
stacked on a leading layer axis; ``wte`` zero-padded to the padded vocab;
BN running statistics into the batch-stats tree.  Conv kernels stay OIHW.

``from_jax_params`` takes the JAX package's tree as nested dicts of numpy
arrays; the layouts are the same except the conv kernels (HWIO -> OIHW).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _tensor(x, dtype=torch.float32, device=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=dtype)


def _adapter_linear_idx(add_layernorm: bool) -> Tuple[int, int]:
    # Sequential(maybe LN, down, ReLU, up): reference adapters.py:15-26
    return (1, 3) if add_layernorm else (0, 2)


def _lm_from_state_dict(sd: Dict, lm_cfg, device=None,
                        prefix: str = "lm.transformer.") -> Dict:
    L = lm_cfg.n_layers
    pd, apd = lm_cfg.param_dtype, lm_cfg.adapter_param_dtype
    mlp_ad, attn_ad = lm_cfg.mlp_adapter, lm_cfg.attn_adapter
    mlp_base = "mlp.0." if mlp_ad is not None else "mlp."
    if attn_ad is None:
        attn_base = "attn.attention."
    elif attn_ad.adapter_type == "normal":
        attn_base = "attn.attn_block.attention."
    else:
        attn_base = "attn.module.attention."

    def get(name):
        v = sd[prefix + name]
        return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))

    def stack(fmt, dtype=pd, linear=False):
        # per layer: cast (and transpose) first, so no fp32 copy of the
        # whole stack exists at once
        def one(i):
            t = get(fmt.format(i=i))
            return _tensor(t.T if linear else t, dtype, device)

        return torch.stack([one(i) for i in range(L)])

    wte = _tensor(get("wte.weight"), pd, device)
    pad = lm_cfg.padded_vocab_size - wte.shape[0]
    if pad > 0:
        wte = torch.cat([wte, wte.new_zeros((pad, wte.shape[1]))])

    h = "h.{i}."
    params = {
        "wte": wte,
        "ln_f": {"scale": _tensor(get("ln_f.weight"), pd, device),
                 "bias": _tensor(get("ln_f.bias"), pd, device)},
        "blocks": {
            "ln_1": {"scale": stack(h + "ln_1.weight"), "bias": stack(h + "ln_1.bias")},
            "attn": {
                key: stack(h + attn_base + f"{name}.weight", linear=True)
                for key, name in (("q", "q_proj"), ("k", "k_proj"),
                                  ("v", "v_proj"), ("o", "out_proj"))
            },
            "mlp": {
                "fc_in": {"kernel": stack(h + mlp_base + "c_fc.weight", linear=True),
                          "bias": stack(h + mlp_base + "c_fc.bias")},
                "fc_out": {"kernel": stack(h + mlp_base + "c_proj.weight", linear=True),
                           "bias": stack(h + mlp_base + "c_proj.bias")},
            },
        },
    }
    if lm_cfg.attn_out_bias:
        params["blocks"]["attn"]["o_bias"] = stack(h + attn_base + "out_proj.bias")

    for key, spec, base in (("adapter_mlp", mlp_ad, "mlp.1.adapter."),
                            ("adapter_attn", attn_ad, "attn.adapter.")):
        if spec is None:
            continue
        d, u = _adapter_linear_idx(spec.add_layernorm)
        ad = {
            "down": {"kernel": stack(h + base + f"{d}.weight", apd, linear=True),
                     "bias": stack(h + base + f"{d}.bias", apd)},
            "up": {"kernel": stack(h + base + f"{u}.weight", apd, linear=True),
                   "bias": stack(h + base + f"{u}.bias", apd)},
        }
        if spec.add_layernorm:
            ad["ln"] = {"scale": stack(h + base + "0.weight", apd),
                        "bias": stack(h + base + "0.bias", apd)}
        if key == "adapter_attn" and spec.adapter_type == "scaled_parallel":
            ad["scale"] = stack(h + "attn.adapter_scale", apd).reshape(L)
        params["blocks"][key] = ad
    return params


def _clip_resnet_from_state_dict(sd: Dict, enc_cfg, device=None,
                                 prefix: str = "") -> Tuple[Dict, Dict]:
    def t(name):
        return _tensor(sd[prefix + name], torch.float32, device)

    def bn(name):
        return ({"scale": t(name + ".weight"), "bias": t(name + ".bias")},
                {"mean": t(name + ".running_mean"), "var": t(name + ".running_var")})

    params: Dict = {"stem": {}}
    stats: Dict = {"stem": {}}
    for i in (1, 2, 3):
        params["stem"][f"conv{i}"] = t(f"conv{i}.weight")
        params["stem"][f"bn{i}"], stats["stem"][f"bn{i}"] = bn(f"bn{i}")
    for stage, n_blocks in enumerate(enc_cfg.blocks, start=1):
        stage_p, stage_s = [], []
        for b in range(n_blocks):
            base = f"layer{stage}.{b}."
            bp: Dict = {}
            bs: Dict = {}
            for c in (1, 2, 3):
                bp[f"conv{c}"] = t(f"{base}conv{c}.weight")
                bp[f"bn{c}"], bs[f"bn{c}"] = bn(f"{base}bn{c}")
            if f"{prefix}{base}downsample.0.weight" in sd:
                bp["down_conv"] = t(f"{base}downsample.0.weight")
                bp["down_bn"], bs["down_bn"] = bn(f"{base}downsample.1")
            stage_p.append(bp)
            stage_s.append(bs)
        params[f"layer{stage}"] = stage_p
        stats[f"layer{stage}"] = stage_s
    return params, stats


def _clip_vit_from_state_dict(sd: Dict, enc_cfg, device=None, prefix: str = "") -> Dict:
    """OpenAI CLIP ``VisionTransformer`` names -> the clip_vit tree
    (``torch_convert.py:292``): the fused in_proj rows [q; k; v] transposed
    into columns [q | k | v]; ``proj`` (W, embed_dim) stored as it is."""
    def t(name, transpose=False):
        x = torch.as_tensor(sd[prefix + name])
        return _tensor(x.T if transpose else x, device=device)

    def stack(fmt, transpose=False):
        return torch.stack([t(fmt.format(i=i), transpose) for i in range(enc_cfg.layers)])

    def ln(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    rb = "transformer.resblocks.{i}."
    return {
        "patch_embed": t("conv1.weight"),
        "class_token": t("class_embedding"),
        "pos_embed": t("positional_embedding"),
        "ln_pre": ln("ln_pre"),
        "blocks": {
            "ln_1": {"scale": stack(rb + "ln_1.weight"), "bias": stack(rb + "ln_1.bias")},
            "attn": {
                "qkv": {"kernel": stack(rb + "attn.in_proj_weight", True),
                        "bias": stack(rb + "attn.in_proj_bias")},
                "out": {"kernel": stack(rb + "attn.out_proj.weight", True),
                        "bias": stack(rb + "attn.out_proj.bias")},
            },
            "ln_2": {"scale": stack(rb + "ln_2.weight"), "bias": stack(rb + "ln_2.bias")},
            "mlp": {
                "fc": {"kernel": stack(rb + "mlp.c_fc.weight", True),
                       "bias": stack(rb + "mlp.c_fc.bias")},
                "proj": {"kernel": stack(rb + "mlp.c_proj.weight", True),
                         "bias": stack(rb + "mlp.c_proj.bias")},
            },
        },
        "ln_post": ln("ln_post"),
        "proj": t("proj"),
    }


def _nf_resnet_from_state_dict(sd: Dict, enc_cfg, device=None, prefix: str = "") -> Dict:
    """timm ``NormFreeNet`` names -> the nfnet tree (``torch_convert.py:365``).
    timm builds nf_resnet50 without skipinit, so a missing
    ``skipinit_gain`` imports as 1.0 (the residual ``shortcut + 0.2 * gain *
    f(x)`` is then timm's ``shortcut + 0.2 * f(x)``)."""
    def ws(base):
        return {"kernel": _tensor(sd[base + ".weight"], device=device),
                "gain": _tensor(sd[base + ".gain"], device=device).reshape(-1),
                "bias": _tensor(sd[base + ".bias"], device=device)}

    params: Dict = {"stem": ws(prefix + "stem.conv")}
    for stage, n_blocks in enumerate(enc_cfg.blocks, start=1):
        blocks = []
        for b in range(n_blocks):
            base = f"{prefix}stages.{stage - 1}.{b}."
            gain = sd.get(base + "skipinit_gain", 1.0)
            bp = {"conv1": ws(base + "conv1"), "conv2": ws(base + "conv2"),
                  "conv3": ws(base + "conv3"),
                  "skipinit_gain": _tensor(gain, device=device).reshape(())}
            if base + "downsample.conv.weight" in sd:
                bp["down"] = ws(base + "downsample.conv")
            blocks.append(bp)
        params[f"layer{stage}"] = blocks
    return params


def convert_encoder_state_dict(sd: Dict, prefix_cfg, prefix: str = "",
                               device=None) -> Tuple[Dict, Dict]:
    """A tower's torch state dict -> (params, batch stats) of the port
    (``torch_convert.py:444``): the CLIP ResNets (checkpoint names), the
    CLIP ViT-B/32 ("clip", OpenAI names: ``prefix="visual."`` for a whole
    CLIP model's file) and timm's nf_resnet50.  The ViT and the NF-ResNet
    keep no statistics: theirs is {} (the JAX package returns None)."""
    name = prefix_cfg.encoder_name
    _, enc_cfg, _ = prefix_cfg.encoder
    if name.startswith("clip_resnet") or name == "clip_rn50":
        return _clip_resnet_from_state_dict(sd, enc_cfg, device, prefix)
    if name == "clip":
        return _clip_vit_from_state_dict(sd, enc_cfg, device, prefix), {}
    if name == "nfresnet50":
        return _nf_resnet_from_state_dict(sd, enc_cfg, device, prefix), {}
    raise ValueError(f"image encoder {name} not recognized")


def load_pretrained_encoder(model, path_or_sd, prefix: str = "auto") -> None:
    """Put a published tower's weights (an OpenAI CLIP model file, a timm
    nf_resnet50 checkpoint) into ``model.params["image_prefix"]["enc"]``
    and its statistics into ``model.state`` (``torch_convert.py:466``), on
    the model's device.  ``prefix="auto"`` detects CLIP's ``visual.``
    nesting; a ``state_dict`` entry is unwrapped."""
    if isinstance(path_or_sd, (str, Path)):
        sd = torch.load(str(path_or_sd), map_location="cpu", weights_only=False)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    else:
        sd = path_or_sd
    if prefix == "auto":
        prefix = "visual." if any(k.startswith("visual.") for k in sd) else ""
    enc, stats = convert_encoder_state_dict(sd, model.prefix_config, prefix, model.device)
    model.params["image_prefix"]["enc"] = enc
    model.state["image_prefix"]["enc"] = stats


def convert_state_dict(sd: Dict, lm_cfg, prefix_cfg, device=None) -> Tuple[Dict, Dict]:
    """Reference-named state dict (torch tensors or numpy arrays) ->
    (params, state) of the port, on ``device``."""
    ip: Dict = {"proj": {
        "kernel": _tensor(torch.as_tensor(sd["image_prefix.proj.weight"]).T, device=device),
        "bias": _tensor(sd["image_prefix.proj.bias"], device=device),
    }}
    if "image_prefix.ln.weight" in sd:
        ip["ln"] = {"scale": _tensor(sd["image_prefix.ln.weight"], device=device),
                    "bias": _tensor(sd["image_prefix.ln.bias"], device=device)}
    ip["enc"], enc_stats = convert_encoder_state_dict(sd, prefix_cfg, "image_prefix.enc.",
                                                      device)
    params = {"lm": _lm_from_state_dict(sd, lm_cfg, device), "image_prefix": ip}
    return params, {"image_prefix": {"enc": enc_stats}}


def load_torch_checkpoint(path: str, lm_cfg, prefix_cfg, device=None) -> Tuple[Dict, Dict]:
    """Load an ``mp_rank_00_model_states.pt``-style file, unwrapping
    ``sd["module"]`` as the reference does (magma.py:288-297)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "module" in sd:
        sd = sd["module"]
    return convert_state_dict(sd, lm_cfg, prefix_cfg, device)


# subtrees of the int8 and int4 serving layouts, whose leaves keep their
# stored dtype
_SERVING_PACKS = ("in_proj", "out_proj", "lm_head_q", "fused", "bvecs")
# the JAX int4 layout's step-major copies of its scales, for the TPU's DMAs
# (``quant._pack_boundary_scales``); the port's kernels read "s4"
_TPU_ONLY_LEAVES = ("dsb", "dsb2")


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def from_jax_params(params_np: Dict, state_np: Optional[Dict], lm_cfg, prefix_cfg,
                    device=None) -> Tuple[Dict, Dict]:
    """The JAX package's (params, state) trees, as nested dicts of numpy
    arrays, -> the port's (params, state) on ``device``.

    LM leaves take ``lm_cfg.param_dtype`` (adapters its
    ``adapter_param_dtype``), except those of the int8 serving and QLoRA
    layouts (``gptj.quantize_lm_params``), which keep the dtype JAX stores
    them in: int8 weights and int4 packs, fp32 scales, biases and ``bvecs``
    (and every {"q", "s"} pack, such as the QLoRA layout's o); the
    int4 layout's "dsb"/"dsb2" are dropped, so the tree has the leaves of
    the port's own ``quantize_lm_params_int4``.  Any other top-level
    subtree (a ``MagmaClassifier``'s ``class_head``) comes as fp32.  The
    image prefix and BN
    stats stay fp32; conv kernels (every 4-D leaf of the three towers: the
    CLIP ResNets' convs, the ViT's patch embedding, the NF-ResNet's WS
    kernels) go HWIO -> OIHW, every other leaf keeps its shape (the
    NF-ResNet's 0-d ``skipinit_gain`` too)."""
    del prefix_cfg  # the same rule for every tower's tree

    def in_pack(path):  # a leaf of an int8 {"q", "s"} pack
        node = params_np["lm"]
        for p in path[:-1]:
            node = node[p]
        return isinstance(node, dict) and {"q", "s"} <= node.keys()

    def lm_leaf(path, a):
        if any(p in _SERVING_PACKS for p in path) or in_pack(path):
            return torch.from_numpy(np.array(a)).to(device)
        is_adapter = any(str(p).startswith("adapter") for p in path)
        return _tensor(a, lm_cfg.adapter_param_dtype if is_adapter else lm_cfg.param_dtype,
                       device)

    def prefix_leaf(path, a):
        a = np.asarray(a, np.float32)
        if a.ndim == 4:  # conv kernel
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return _tensor(a, device=device)

    def drop_tpu_only(tree):
        if not isinstance(tree, dict):
            return tree
        return {k: drop_tpu_only(v) for k, v in tree.items() if k not in _TPU_ONLY_LEAVES}

    params = {
        "lm": _walk(drop_tpu_only(params_np["lm"]), lm_leaf),
        "image_prefix": _walk(params_np["image_prefix"], prefix_leaf),
    }
    for key in params_np.keys() - params.keys():  # a classifier's class_head
        params[key] = _walk(params_np[key], lambda _, a: _tensor(a, device=device))
    state = _walk(state_np or {"image_prefix": {"enc": {}}},
                  lambda _, a: _tensor(a, device=device))
    return params, state
