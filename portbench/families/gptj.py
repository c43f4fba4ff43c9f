"""GPT-J 6B with MAGMA's adapters: the language-model family of
``magma_v1`` and ``magma_v2``, and of every configuration whose ``model``
names no ``family``.

A family module is everything the harness needs of one language-model
family. The harness finds it by the configuration's ``model.family``
(absent: ``"gptj"``) as ``portbench/families/<family>.py``
(``harness.family``), so a configuration on another family comes with a
module of its own and changes no file that is there. Nothing a family
imports may come from the program. A family module gives:

* ``make_weights(model, seed, device)`` -> {"lm", "image_prefix", "stats"}:
  the seeded weights, in the layout the program's ``Magma`` keeps in
  ``params`` and ``state``, made on ``device``;
* the served reference: ``embed_prompt(weights, parts, model, device)`` ->
  a prompt's (s, d_model) embeddings, and ``lm_logits(weights, model,
  embeds, tokens, bits, head_bits)`` -> the teacher-forced logits of each
  served token, its layers' weights in the ``bits`` layout;
* the training reference: ``run_steps(weights, model, recipe, batches,
  seed, device, n_steps, low_precision)`` (``reference/train_ref.py``'s
  contract), and ``trainable_init(weights)`` -> {path: leaf} of the leaves
  the recipe trains, as the comparison holds them;
* model FLOPs: ``train_sample_flops(model, n, labels)`` (one training
  sample of ``n`` true positions and ``labels`` predicted tokens),
  ``prompt_flops(model, n)`` (the LM's causal prefill of ``n`` positions,
  the head at the last) and ``lm_token_flops(model, context)`` (one new
  position over ``context``, the head included);
* ``WRAPPERS``: {traffic driver's name: {wrapper: (module, extractor)}},
  the family's kernel wrappers whose launches that driver's traced slice
  logs beside its own (``trace.WrapperLog``);
* ``ROOFLINES``: {roofline name: (kernel name patterns, call kinds)} of the
  family's own kernels, and ``least_s(call, model)``, the least time of a
  logged launch of one of those kinds (``rooflines.py`` asks the family
  first);
* ``check_config(f, program)``: asserts that the configuration file ``f``
  states what the program builds from its ``yml`` (``program``: the
  program's ``Magma`` built without weights; the manifest test's hook).
"""

from portbench import cost
from portbench.reference import magma_ref, train_ref
from portbench.weights import make_weights  # noqa: F401

embed_prompt = magma_ref.embed_prompt
lm_logits = magma_ref.lm_logits
run_steps = train_ref.run_steps
train_sample_flops = cost.train_sample_flops


def adapter_widths(model):
    d = model["lm"]["d_model"]
    return [d // a["downsample_factor"] for a in model.get("adapters", {}).values()]


def trainable_init(weights):
    """The adapters' and the ImagePrefix's leaves, by path."""
    return dict(train_ref.paths(
        {"lm": {"blocks": {k: v for k, v in weights["lm"]["blocks"].items() if "adapter" in k}},
         "image_prefix": weights["image_prefix"]}))


def prompt_flops(model, n):
    return cost.prompt_flops(model["lm"], adapter_widths(model), n)


def lm_token_flops(model, context):
    return cost.lm_token_flops(model["lm"], adapter_widths(model), context)


def _pos(t):
    """A cache position as given: a device tensor is cloned, read later."""
    return t.clone() if hasattr(t, "clone") else t


def _position(p) -> int:
    return int(p.reshape(-1)[0]) if hasattr(p, "reshape") else int(p)


WRAPPERS = {"generate_closed": {
    "decode_all_layers_kernel": ("magma_tpu_torch.ops.decode_layer", lambda a, k: (
        "k8", _pos(a[7] if len(a) > 7 else k["cache_pos"]), a[4].element_size())),
}}
# K8 (csrc/decode_layer.cu): every layer's decode step at b = 1
ROOFLINES = {"k8": ((r"anonymous namespace\)::decode_stream_kernel",), ("k8",))}


def least_s(call, model):
    kind, args = call[0], call[1:]
    if kind != "k8":
        raise ValueError(f"no cost for a {kind!r} launch")
    return cost.least_s(*cost.decode_all_layers(model["lm"], adapter_widths(model),
                                                _position(args[0]), kv_bytes=args[1]))


def check_config(f, program):
    assert f["reduced"] == []
    lm, cfg = program.lm_config, program.config
    want = f["model"]["lm"]
    assert (lm.n_layers, lm.d_model, lm.n_heads, lm.d_ff, lm.rotary_dim, lm.vocab_size,
            lm.padded_vocab_size, lm.max_seq_len) == (
        want["n_layers"], want["d_model"], want["n_heads"], want["d_ff"],
        want["rotary_dim"], want["vocab_size"], want["padded_vocab_size"],
        want["max_seq_len"])
    for where, spec in (("mlp", lm.mlp_adapter), ("attention", lm.attn_adapter)):
        got = f["model"]["adapters"].get(where)
        assert (spec is None) == (got is None)
        if spec:
            assert spec.downsample_factor == got["downsample_factor"]
            assert spec.adapter_type == got["adapter_type"]
    enc = program.prefix_config.encoder[1]
    tw = f["model"]["tower"]
    assert (enc.width, tuple(enc.blocks), enc.input_resolution) == (
        tw["width"], tuple(tw["blocks"]), tw["input_resolution"])
    assert cfg.use_image_embed_layernorm == f["model"]["image_prefix"]["layernorm"]
    if "recipe" in f:
        r = f["recipe"]
        assert (cfg.lr, cfg.min_lr, cfg.warmup_num_steps, cfg.lr_decay_iters,
                cfg.image_enc_lr, cfg.weight_decay, cfg.gradient_clipping,
                cfg.image_embed_dropout_prob) == (
            r["lr"], r["min_lr"], r["warmup_num_steps"], r["lr_decay_iters"],
            r["image_enc_lr"], r["weight_decay"], r["clip"], r["dropout"])
        assert enc.bn_momentum == r["bn_momentum"]
