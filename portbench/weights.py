"""Seeded weights for a configuration, made on the device in a few large calls.

The benchmark makes the weights and hands the same tensors to the program
under test and, made again from the same seed, to the plain reference.  The
tree follows the layout the port's ``Magma`` keeps in ``params``/``state``
(layer-stacked LM leaves, a list of blocks per tower stage), which is also
the layout the reference reads.  Every draw comes from one
``torch.Generator`` on ``device`` seeded with ``seed``, in a fixed order, so
the same seed gives the same tensors on the same device.

Distributions (listed under ``assumed`` in each configuration file):
LM matrices N(0, 0.02) in bf16 (GPT-J's init); LM biases N(0, 0.02) and
layernorm scales 1 + N(0, 0.05), so a path that drops either is seen;
adapters N(0, ``adapter_std``) (the published N(0, 1e-3) adds ~1e-3 of its
branch, under any comparison's reach); the CLIP ResNet's convs He-init
N(0, 2 / fan_in) with BatchNorm scale 1 + N(0, 0.05), bias, mean N(0, 0.05)
and variance 1 + U(0, 0.1); the ImagePrefix projection N(0, 1 / enc_dim).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

EXPANSION = 4  # the CLIP ResNet bottleneck's expansion


def tower_layout(tower: Dict) -> List[Tuple[str, int, int, int, int]]:
    """The tower's blocks in order: (stage key, block index, cin, planes,
    stride) for every bottleneck of ``tower`` ({"width", "blocks"})."""
    w, out, cin = tower["width"], [], tower["width"]
    for stage, n_blocks in enumerate(tower["blocks"], start=1):
        planes = w * 2 ** (stage - 1)
        for b in range(n_blocks):
            out.append((f"layer{stage}", b, cin, planes, (2 if stage > 1 else 1) if b == 0 else 1))
            cin = planes * EXPANSION
    return out


def _conv_shapes(tower: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path, OIHW shape) of every conv of the tower, in draw order."""
    w = tower["width"]
    shapes = [(("stem", f"conv{i}"), (co, ci, 3, 3))
              for i, (ci, co) in enumerate([(3, w // 2), (w // 2, w // 2), (w // 2, w)], start=1)]
    for stage, b, cin, planes, stride in tower_layout(tower):
        cout = planes * EXPANSION
        shapes += [((stage, str(b), "conv1"), (planes, cin, 1, 1)),
                   ((stage, str(b), "conv2"), (planes, planes, 3, 3)),
                   ((stage, str(b), "conv3"), (cout, planes, 1, 1))]
        if b == 0 and (stride > 1 or cin != cout):
            shapes.append(((stage, str(b), "down_conv"), (cout, cin, 1, 1)))
    return shapes


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node[int(key)] if isinstance(node, list) else node.setdefault(key, {})
    node[path[-1]] = value


def make_tower(g: torch.Generator, tower: Dict, device) -> Tuple[Dict, Dict]:
    """(params, batch statistics) of the CLIP ResNet, fp32: all convs from one
    draw, all BatchNorm vectors from four.  ``tower["init"]``: "he" (the
    default above) or "clip", OpenAI CLIP's own ``initialize_parameters``
    for the ModifiedResNet: torch's default conv init, U(+-1/sqrt(fan_in)),
    identity BatchNorm with each bottleneck's ``bn3`` scale at zero, so
    every residual branch starts closed."""
    shapes = _conv_shapes(tower)
    clip = tower.get("init", "he") == "clip"
    n_conv = sum(_numel(s) for _, s in shapes)
    flat = (torch.rand(n_conv, generator=g, device=device).mul_(2).sub_(1) if clip
            else torch.randn(n_conv, generator=g, device=device))
    params: Dict = {"stem": {}}
    stats: Dict = {"stem": {}}
    for stage, *_ in tower_layout(tower):
        params.setdefault(stage, [])
        stats.setdefault(stage, [])
    for stage, b, *_ in tower_layout(tower):
        params[stage].append({})
        stats[stage].append({})
    bn_sizes, off = [], 0
    for path, shape in shapes:
        n = _numel(shape)
        fan_in = shape[1] * shape[2] * shape[3]
        std = fan_in ** -0.5 if clip else (2.0 / fan_in) ** 0.5
        _put(params, path, flat[off:off + n].view(shape).mul_(std))
        off += n
        bn_path = path[:-1] + ("down_bn" if path[-1] == "down_conv" else "bn" + path[-1][4:],)
        bn_sizes.append((bn_path, shape[0]))
    total = sum(c for _, c in bn_sizes)
    if clip:
        scale, bias = torch.ones(total, device=device), torch.zeros(total, device=device)
        mean, var = torch.zeros(total, device=device), torch.ones(total, device=device)
    else:
        scale = 1.0 + 0.05 * torch.randn(total, generator=g, device=device)
        bias = 0.05 * torch.randn(total, generator=g, device=device)
        mean = 0.05 * torch.randn(total, generator=g, device=device)
        var = 1.0 + 0.1 * torch.rand(total, generator=g, device=device)
    off = 0
    for path, c in bn_sizes:
        if clip and path[0] != "stem" and path[-1] == "bn3":  # the blocks', not the stem's
            scale[off:off + c] = 0.0
        _put(params, path, {"scale": scale[off:off + c], "bias": bias[off:off + c]})
        _put(stats, path, {"mean": mean[off:off + c], "var": var[off:off + c]})
        off += c
    return params, stats


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _normal(g, shape, std, dtype, device, mean=0.0):
    t = torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(std)
    return t.add_(mean) if mean else t


def make_lm(g: torch.Generator, lm: Dict, adapters: Dict, adapter_std: float,
            device) -> Dict:
    """The GPT-J tree with its adapters: matrices and vectors in bf16 (the
    frozen LM's storage type), adapters in fp32 (their parameter type)."""
    L, D, F, Vp = lm["n_layers"], lm["d_model"], lm["d_ff"], lm["padded_vocab_size"]
    bf = torch.bfloat16

    def n(shape, std=0.02, mean=0.0, dtype=bf):
        return _normal(g, shape, std, dtype, device, mean)

    wte = n((Vp, D))
    wte[lm["vocab_size"]:] = 0  # padding rows: never looked up or sampled
    params = {
        "wte": wte,
        "blocks": {
            "ln_1": {"scale": n((L, D), 0.05, 1.0), "bias": n((L, D))},
            "attn": {k: n((L, D, D)) for k in ("q", "k", "v", "o")},
            "mlp": {"fc_in": {"kernel": n((L, D, F)), "bias": n((L, F))},
                    "fc_out": {"kernel": n((L, F, D)), "bias": n((L, D))}},
        },
        "ln_f": {"scale": n((D,), 0.05, 1.0), "bias": n((D,))},
    }
    if lm.get("attn_out_bias", True):
        params["blocks"]["attn"]["o_bias"] = n((L, D))
    for where in ("mlp", "attention"):
        spec = adapters.get(where)
        if spec is None:
            continue
        dh = D // spec["downsample_factor"]
        ad = {"down": {"kernel": n((L, D, dh), adapter_std, dtype=torch.float32),
                       "bias": n((L, dh), adapter_std, dtype=torch.float32)},
              "up": {"kernel": n((L, dh, D), adapter_std, dtype=torch.float32),
                     "bias": n((L, D), adapter_std, dtype=torch.float32)}}
        if spec.get("add_layernorm"):
            ad["ln"] = {"scale": n((L, D), 0.05, 1.0, torch.float32),
                        "bias": n((L, D), 0.05, dtype=torch.float32)}
        if spec["adapter_type"] == "scaled_parallel":
            ad["scale"] = n((L,), 0.05, 1.0, torch.float32)
        params["blocks"]["adapter_mlp" if where == "mlp" else "adapter_attn"] = ad
    return params


def make_weights(model: Dict, seed: int, device) -> Dict:
    """Everything a configuration's ``model`` section describes, from ``seed``:
    {"lm": GPT-J tree, "image_prefix": {"enc", "proj", "ln"}, "stats":
    {"enc": BatchNorm statistics}}."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    with torch.no_grad():
        lm = make_lm(g, model["lm"], model.get("adapters", {}), model["adapter_std"], device)
        enc, stats = make_tower(g, model["tower"], device)
        enc_dim, d = model["tower"]["width"] * 32, model["lm"]["d_model"]
        prefix = {"enc": enc,
                  "proj": {"kernel": _normal(g, (enc_dim, d), enc_dim ** -0.5, torch.float32,
                                             device),
                           "bias": _normal(g, (d,), 0.02, torch.float32, device)}}
        if model["image_prefix"].get("layernorm"):
            prefix["ln"] = {"scale": _normal(g, (d,), 0.05, torch.float32, device, 1.0),
                            "bias": _normal(g, (d,), 0.02, torch.float32, device)}
    return {"lm": lm, "image_prefix": prefix, "stats": {"enc": stats}}
