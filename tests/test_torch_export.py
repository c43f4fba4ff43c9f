"""The port's export, ``convert.to_torch_state_dict``, and its converter CLI
against the JAX package's, on the CPU.

Weights come from the port's ``Magma`` at a tiny width (2 layers,
d_model 128, one 128-wide head), every leaf moved off its init; the JAX
package gets them in its layout (conv kernels HWIO), which
``convert.from_jax_params`` takes back to the port's tree unchanged, and
its configs from its own ``build_lm_config``/``build_prefix_config`` (no
JAX model is built: its init compiles for seconds).  The two exports of
the same weights must agree key for key and byte for byte (fp32 in both: the export only
transposes, unstacks and casts), for the three tower families and for
every adapter type with and without its LN; the port's export read back by
``convert_state_dict`` gives the tree it came from.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.config import MultimodalConfig as JConfig
from magma_tpu.models.magma import build_lm_config, build_prefix_config
from magma_tpu.training.torch_convert import to_torch_state_dict as jax_export
from magma_tpu_torch.config import MultimodalConfig as TConfig
from magma_tpu_torch.convert import convert_state_dict, from_jax_params, to_torch_state_dict
from magma_tpu_torch.models import gptj as tgptj
from magma_tpu_torch.models import image_prefix as tip
from magma_tpu_torch.models.magma import Magma as TMagma
from magma_tpu_torch.utils import tree_items, tree_map

ROOT = Path(__file__).resolve().parents[1]
TOWERS = {
    "clip_resnet_large": dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64),
    "clip": dict(input_resolution=64, patch_size=16, width=32, layers=2, heads=4, embed_dim=24),
    "nfresnet50": dict(width=8, blocks=(1, 2, 1, 1), input_resolution=64),
}


def _ad(kind, k, ln=False):
    return {"adapter_type": kind, "downsample_factor": k, "add_layernorm": ln}


# tower x adapters: normal, parallel and scaled_parallel, each with and
# without an LN, the attention adapter in each of its three checkpoint
# layouts (attn_block, module, none)
CASES = {
    "resnet_v2": ("clip_resnet_large", {"mlp": _ad("normal", 4), "attention": _ad("normal", 8)}),
    "vit_parallel_ln_scaled": ("clip", {"mlp": _ad("parallel", 4, True),
                                        "attention": _ad("scaled_parallel", 8)}),
    "nf_normal_ln_parallel": ("nfresnet50", {"mlp": _ad("normal", 4, True),
                                             "attention": _ad("parallel", 4)}),
    "resnet_scaled_ln": ("clip_resnet_large", {"attention": _ad("scaled_parallel", 4, True)}),
}


def _kwargs(tower, adapters):
    return dict(
        batch_size=2, train_steps=4, encoder_name=tower, adapter_config=adapters,
        image_seq_len=2, use_image_embed_layernorm=tower != "nfresnet50",
        image_embed_dropout_prob=0.0, image_size=64,
        lm_overrides=dict(n_layers=2, n_heads=1, d_model=128, d_ff=512, rotary_dim=16,
                          max_seq_len=128, attention_impl="xla"),
        compute_dtype="float32", param_dtype="float32", frozen_dtype="float32",
        attention_impl="xla")


class _Jax:
    """What the JAX export reads: its configs and the tree in its layout."""

    def __init__(self, tower, adapters, params, state):
        cfg = JConfig(**_kwargs(tower, adapters),
                      encoder_overrides=dict(TOWERS[tower], compute_dtype=jnp.float32))
        self.lm_config = build_lm_config(cfg)
        self.prefix_config = build_prefix_config(cfg, self.lm_config)
        hwio = {"image_prefix": lambda a: a.transpose(2, 3, 1, 0) if a.ndim == 4 else a}
        self.params = {k: tree_map(lambda t: hwio.get(k, lambda a: a)(t.numpy()), v)
                       for k, v in params.items()}
        self.state = tree_map(lambda t: t.numpy(), state)


def _pair(case):
    """(the weights for the JAX export, the port's model with them)."""
    tower, adapters = CASES[case]
    tm = TMagma(TConfig(**_kwargs(tower, adapters),
                        encoder_overrides=dict(TOWERS[tower], compute_dtype=torch.float32)),
                seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    tm.params = tree_map(lambda t: t + torch.randn(t.shape, generator=g) * 0.02, tm.params)
    tm.params["lm"]["wte"][tm.lm_config.vocab_size:] = 0  # as an import makes the padding
    tm.state = tree_map(lambda t: t + torch.randn(t.shape, generator=g).abs() * 0.2, tm.state)
    jm = _Jax(tower, adapters, tm.params, tm.state)
    params, state = from_jax_params(jm.params, jm.state, tm.lm_config, tm.prefix_config)
    for tree, back in ((tm.params, params), (tm.state, state)):  # the same weights
        want = dict(tree_items(tree))
        assert all(torch.equal(t, want[k]) for k, t in tree_items(back))
    return jm, tm


def _same_bytes(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu", k
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].numpy().tobytes() == np.ascontiguousarray(w).tobytes(), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_equals_jax_and_reads_back(case):
    jm, tm = _pair(case)
    sd = to_torch_state_dict(tm.params, tm.state, tm.lm_config, tm.prefix_config)
    _same_bytes(sd, jax_export(jm.params, jm.state, jm.lm_config, jm.prefix_config))
    assert sd["lm.transformer.wte.weight"].shape[0] == tm.lm_config.vocab_size
    if CASES[case][0] == "clip_resnet_large":  # no state: every BN stat is mean 0, var 1
        _same_bytes(to_torch_state_dict(tm.params, None, tm.lm_config, tm.prefix_config),
                    jax_export(jm.params, None, jm.lm_config, jm.prefix_config))
    params, state = convert_state_dict(sd, tm.lm_config, tm.prefix_config)
    for tree, back in ((tm.params, params), (tm.state, state)):
        want, got = dict(tree_items(tree)), dict(tree_items(back))
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert torch.equal(t, want[k]), k


def test_serving_layouts_raise_naming_the_leaf():
    _, tm = _pair("resnet_v2")
    lm = tgptj.quantize_lm_params(tree_map(torch.clone, tm.params["lm"]))
    with pytest.raises(ValueError, match="lm/blocks/attn/in_proj"):
        to_torch_state_dict({**tm.params, "lm": lm}, tm.state, tm.lm_config, tm.prefix_config)
    folded = tip.fold_for_serving(tm.params["image_prefix"], tm.state["image_prefix"],
                                  tm.prefix_config)
    with pytest.raises(ValueError, match="image_prefix/enc/stem/conv1"):
        to_torch_state_dict({**tm.params, "image_prefix": folded}, tm.state, tm.lm_config,
                            tm.prefix_config)


def test_converter_cli_writes_a_directory_from_checkpoint_loads(tmp_path):
    """``python -m magma_tpu_torch.convert`` in a subprocess (jax blocked) on
    a tiny reference-named ``.pt``, asked for the CPU: the directory it
    writes restores through ``Magma.from_checkpoint`` to the tensors of the
    ``.pt``.  Not asked, it takes the card, and raises without CUDA."""
    _, tm = _pair("resnet_v2")
    sd = to_torch_state_dict(tm.params, tm.state, tm.lm_config, tm.prefix_config)
    torch.save({"module": sd}, tmp_path / "mp_rank_00_model_states.pt")
    yml = tmp_path / "tiny.yml"
    yml.write_text("""{
 encoder_name: 'clip_resnet_large', batch_size: 2, train_steps: 4, image_seq_len: 2,
 adapter_config: {"mlp": {"adapter_type": "normal", "downsample_factor": 4},
                  "attention": {"adapter_type": "normal", "downsample_factor": 8}},
 use_image_embed_layernorm: true, image_embed_dropout_prob: 0.0, image_size: 64,
 compute_dtype: 'float32', param_dtype: 'float32', frozen_dtype: 'float32',
 attention_impl: 'xla',
 lm_overrides: {n_layers: 2, n_heads: 1, d_model: 128, d_ff: 512, rotary_dim: 16,
                max_seq_len: 128, attention_impl: 'xla'},
 encoder_overrides: {width: 16, blocks: [1, 1, 1, 1], input_resolution: 64},
}""")
    code = ("import runpy, sys; sys.modules['jax'] = None\n"
            "runpy.run_module('magma_tpu_torch.convert', run_name='__main__', alter_sys=True)\n")
    args = [sys.executable, "-c", code, str(tmp_path / "mp_rank_00_model_states.pt"),
            str(tmp_path / "out"), "--config", str(yml)]
    if not torch.cuda.is_available():
        out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and "CUDA is not available" in out.stderr, out.stderr
        assert not (tmp_path / "out").exists()
    out = subprocess.run(args + ["--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "out" / "latest").read_text() == "step_0"
    got = TMagma.from_checkpoint(yml, tmp_path / "out", device="cpu")
    want = dict(tree_items(tm.params))
    for k, t in tree_items(got.params):
        assert torch.equal(t, want[k]), k
    want = dict(tree_items(tm.state))
    assert all(torch.equal(t, want[k]) for k, t in tree_items(got.state))
