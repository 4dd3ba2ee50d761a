"""The port's decoder-LLM text encoders vs the JAX package and transformers.

One tiny random transformers model of each `CausalLMConfig.from_hf_config`
family (Llama; Qwen2 with q/k/v biases; Qwen2.5-VL's text tower with
multimodal RoPE ids; Qwen3 with q/k norms; Mistral with a sliding window of
3; Gemma 2 with sandwich norms, soft-capping and alternating sliding
layers; Gemma 3 with q/k norms, a local RoPE base and a 2-layer sliding
pattern), its norm scales and biases perturbed so that each leaf's mapping
shows. Its state dict goes through the JAX convert_hf_causal_lm and the
port's; the three models run the same ids with right padding. The JAX
config takes the port's RoPE base for sliding layers: the JAX function
leaves it at 10,000 for every family, which makes its Mistral differ from
transformers' (checked here). Tolerances
(f32): the port against the JAX CausalLM 2e-5 on the final state and on
every collected hidden state; against transformers 1e-4 on the final
state (eager attention; its RoPE tables are computed another way).

LLMTextEncoder (template, crop_start, hidden_layer, the mask) against the
JAX LLMTextEncoder on a Qwen2 folder written here, with a synthetic
word-level tokenizer that holds the chat template's special tokens:
hidden states 2e-5, the mask exactly; and with text_encoder_fp8 the port's
2-D weights but the embedding are float8, the output within 2e-5 of the
JAX fp8 encoder's.

Mistral-3 as FLUX.2 [dev] reads it: a tiny random transformers Mistral
language model written in Mistral3ForConditionalGeneration's layout (its
config nested under text_config, its keys under `model.language_model.`,
vision-tower and head keys beside them) loads through load_causal_lm (the
other keys left unread), and LLMTextEncoder's stacked hidden_layers (1, 2,
3) equal transformers' hidden_states of those indices concatenated per
token (1e-4 on the valid rows, eager attention).
"""

import dataclasses
import functools
import json
import os

os.environ.setdefault("USE_TF", "0")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from diffusion_pipe_tpu.models import llm_encoders as jllm  # noqa: E402
from diffusion_pipe_tpu_torch.interop import tree_to_state_dict  # noqa: E402
from diffusion_pipe_tpu_torch.models import llm_encoders as tllm  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_helpers import JAX_FAST_COMPILE, write_qwen_tokenizer  # noqa: E402

BASE = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=8, intermediate_size=48, rms_norm_eps=1e-6,
            attn_implementation="eager")
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaModel", dict(rope_theta=500000.0)),
    "qwen2": ("Qwen2Config", "Qwen2Model", dict(rope_theta=1e6)),
    "qwen2_5_vl": ("Qwen2_5_VLTextConfig", "Qwen2_5_VLTextModel",
                   dict(rope_theta=1e6,
                        rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]})),
    "qwen3": ("Qwen3Config", "Qwen3Model", dict(rope_theta=1e6)),
    "mistral": ("MistralConfig", "MistralModel", dict(rope_theta=1e6, sliding_window=3)),
    "gemma2": ("Gemma2Config", "Gemma2Model",
               dict(sliding_window=3, attn_logit_softcapping=50.0, query_pre_attn_scalar=8,
                    hidden_activation="gelu_pytorch_tanh")),
    "gemma3": ("Gemma3TextConfig", "Gemma3TextModel",
               dict(sliding_window=3, sliding_window_pattern=2, query_pre_attn_scalar=8,
                    rope_theta=1e6, rope_local_base_freq=1e4,
                    hidden_activation="gelu_pytorch_tanh")),
}
IDS = np.random.default_rng(0).integers(1, 96, (2, 10))
MASK = np.ones((2, 10), np.int64)
MASK[1, 7:] = 0


def mrope_ids():
    """[B, 3, S] (t, h, w) ids: a 2 x 3 image block after two text tokens."""
    pos = np.stack([np.arange(10)] * 3)
    pos[:, 2:8] = 2 + np.stack([np.zeros(6, int), np.repeat(np.arange(2), 3),
                                np.tile(np.arange(3), 2)])
    pos[:, 8:] = 5 + np.arange(2)
    return np.stack([pos, pos])


def hf_model(family):
    import transformers

    cfg_cls, model_cls, extra = FAMILIES[family]
    cfg = getattr(transformers, cfg_cls)(**BASE, **extra)
    torch.manual_seed(0)
    model = getattr(transformers, model_cls)(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:  # norm scales (zero for Gemma) and biases away from 0 / 1
                p.add_(0.1 * torch.randn(p.shape))
    return model, {**cfg.to_dict(), "model_type": cfg.model_type}


@functools.partial(jax.jit, static_argnums=0, compiler_options=JAX_FAST_COMPILE)
def _jax_lm(cfg, params, ids, mask, pos):
    return jllm.CausalLM(cfg).apply(params, ids, mask, collect_hidden=True, position_ids=pos)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_causal_lm_matches_jax_and_transformers(family):
    model, hf_cfg = hf_model(family)
    sd = model.state_dict()
    pos = mrope_ids() if family == "qwen2_5_vl" else None

    jcfg = jllm.CausalLMConfig.from_hf_config(hf_cfg, dtype=jnp.float32)
    tcfg = tllm.CausalLMConfig.from_hf_config(hf_cfg, dtype=torch.float32)
    # the JAX function gives every sliding layer RoPE base 10,000 but in
    # Gemma 3; transformers (and the port) keep rope_theta there
    assert tcfg.rope_local_theta == (1e4 if family == "gemma3" else tcfg.rope_theta)
    if family == "mistral":
        assert jcfg.rope_local_theta == 1e4 != tcfg.rope_local_theta
    jcfg = dataclasses.replace(jcfg, rope_local_theta=tcfg.rope_local_theta)
    assert {f: getattr(tcfg, f) for f in ("qkv_bias", "qk_norm", "gemma_norm", "post_norms",
                                          "attn_softcap", "sliding_window", "layer_types",
                                          "mrope_section", "act")} == \
        {f: getattr(jcfg, f) for f in ("qkv_bias", "qk_norm", "gemma_norm", "post_norms",
                                       "attn_softcap", "sliding_window", "layer_types",
                                       "mrope_section", "act")}
    jparams = jllm.convert_hf_causal_lm(sd, jcfg, prefix="")
    jout, jh = _jax_lm(jcfg, jparams, jnp.asarray(IDS), jnp.asarray(MASK),
                       None if pos is None else jnp.asarray(pos))

    port = tllm.CausalLM(tcfg)
    port.load_state_dict(tllm.convert_hf_causal_lm(sd, tcfg, prefix=""))
    # the JAX tree crosses through interop onto the same names
    ported = tree_to_state_dict(jax.tree.map(np.asarray, jparams))
    assert set(ported) == set(port.state_dict())
    with torch.no_grad():
        out, hiddens = port(torch.from_numpy(IDS), torch.from_numpy(MASK), collect_hidden=True,
                            position_ids=None if pos is None else torch.from_numpy(pos))
        kw = {} if pos is None else {"position_ids": torch.from_numpy(pos).permute(1, 0, 2)}
        hf = model(input_ids=torch.from_numpy(IDS), attention_mask=torch.from_numpy(MASK),
                   **kw).last_hidden_state
    assert len(hiddens) == len(jh) == tcfg.num_layers + 1
    for got, want in zip(hiddens, jh):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
    valid = MASK.astype(bool)
    np.testing.assert_allclose(out.numpy()[valid], hf.numpy()[valid], atol=1e-4, rtol=1e-4)


TEMPLATE = "<|im_start|>system\nsay the picture<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n"


@pytest.fixture(scope="module")
def qwen2_folder(tmp_path_factory):
    """A tiny Qwen2 checkpoint (model. prefix) and tokenizer in one folder."""
    from diffusion_pipe_tpu_torch import safetensors_io

    folder = tmp_path_factory.mktemp("qwen2")
    ids = write_qwen_tokenizer(folder, ["say", "the", "picture", "a", "red", "cat", "dog"])
    model, hf_cfg = hf_model("qwen2")
    assert max(ids.values()) < hf_cfg["vocab_size"]
    (folder / "config.json").write_text(json.dumps(hf_cfg, default=str))
    safetensors_io.save_file({"model." + k: v.contiguous() for k, v in model.state_dict().items()},
                             str(folder / "model.safetensors"))
    return folder


@pytest.mark.parametrize("fp8,layer", [(False, 1), (True, -1)], ids=["f32_layer1", "fp8_final"])
def test_text_encoder_crop_and_mask_match_jax(qwen2_folder, fp8, layer):
    caps = ["a red cat", "dog"]
    kw = dict(max_length=6, template=TEMPLATE, crop_start=5, hidden_layer=layer, fp8=fp8)
    port = tllm.LLMTextEncoder(str(qwen2_folder), dtype=torch.float32, **kw)
    h, mask = port.encode(caps)
    ref = jllm.LLMTextEncoder(str(qwen2_folder), dtype=jnp.float32, **kw)
    ref._load()
    ref._jitted = jax.jit(ref._jitted.__wrapped__, compiler_options=JAX_FAST_COMPILE)
    jh, jmask = ref.encode(caps)
    assert h.shape == (2, 6, 32) and mask.shape == (2, 6)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert mask[0].sum() > mask[1].sum() > 0  # the crop keeps the captions' tokens
    np.testing.assert_allclose(h.numpy(), jh, atol=2e-5, rtol=2e-5)
    lin = port.model.layers[0].attn_q.weight
    assert lin.dtype == (torch.float8_e4m3fn if fp8 else torch.float32)
    assert port.model.token_embedding.weight.dtype == torch.float32


def test_mistral3_nested_config_and_stacked_layers(tmp_path):
    import transformers

    from diffusion_pipe_tpu_torch import safetensors_io

    text = transformers.MistralConfig(**{**BASE, "num_hidden_layers": 4}, rope_theta=1e6)
    torch.manual_seed(0)
    model = transformers.MistralModel(text).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape))
    # Mistral3ForConditionalGeneration's layout: the language model's
    # config under text_config, its keys under model.language_model., a
    # Pixtral tower beside it
    hf_cfg = {"model_type": "mistral3", "image_token_index": 10,
              "text_config": {**text.to_dict(), "model_type": "mistral"},
              "vision_config": {"model_type": "pixtral", "hidden_size": 16, "patch_size": 14}}
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg, default=str))
    sd = {"model.language_model." + k: v.contiguous() for k, v in model.state_dict().items()}
    sd["model.vision_tower.patch_conv.weight"] = torch.zeros(16, 3, 14, 14)
    sd["lm_head.weight"] = torch.zeros(96, 32)
    safetensors_io.save_file(sd, str(tmp_path / "model.safetensors"))
    lm, tcfg, _, _ = tllm.load_causal_lm(tmp_path, torch.float32)
    assert (tcfg.dim, tcfg.num_layers, tcfg.num_kv_heads, tcfg.rope_theta) == (32, 4, 2, 1e6)
    enc = tllm.LLMTextEncoder(str(tmp_path), max_length=10, hidden_layers=(1, 2, 3),
                              dtype=torch.float32)
    enc.model = lm
    ids, mask = torch.from_numpy(IDS), torch.from_numpy(MASK)
    with torch.no_grad():
        got = enc.hidden_states(ids, mask)
        hf = model(input_ids=ids, attention_mask=mask, output_hidden_states=True).hidden_states
    want = torch.cat([hf[k] for k in (1, 2, 3)], dim=-1)
    assert got.shape == (2, 10, 96)
    valid = MASK.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want.numpy()[valid], atol=1e-4, rtol=1e-4)


LLAMA31 = dict(vocab_size=96, hidden_size=256, num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, head_dim=128, intermediate_size=64, rms_norm_eps=1e-5,
               rope_theta=500000.0, attn_implementation="eager",
               rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                             "high_freq_factor": 4.0, "original_max_position_embeddings": 8192})


def test_llama31_rope_scaling_matches_transformers():
    """Llama 3.1's rope_type "llama3" (factor 8, low / high frequency factors
    1 / 4, original length 8,192) at head dim 128 and theta 500,000 over 128
    tokens: the port within 2e-5 of transformers' LlamaModel (f32, eager);
    without the scaling it would differ by more than 1e-3 (3.2e-3 measured
    before the port read it)."""
    import transformers

    cfg = transformers.LlamaConfig(**LLAMA31)
    torch.manual_seed(1)
    model = transformers.LlamaModel(cfg).eval()
    hf_cfg = {**cfg.to_dict(), "model_type": "llama"}
    tcfg = tllm.CausalLMConfig.from_hf_config(hf_cfg, dtype=torch.float32)
    assert tcfg.rope_llama3 == (8.0, 1.0, 4.0, 8192.0)
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 96, (1, 128)))
    with torch.no_grad():
        want = model(input_ids=ids).last_hidden_state
        outs = {}
        for name, c in (("scaled", tcfg), ("unscaled", dataclasses.replace(tcfg, rope_llama3=()))):
            port = tllm.CausalLM(c)
            port.load_state_dict(tllm.convert_hf_causal_lm(model.state_dict(), c, prefix=""))
            outs[name] = port(ids)[0]
    np.testing.assert_allclose(outs["scaled"].numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    assert (outs["unscaled"] - want).abs().max() > 1e-3


def _qwen3_vl():
    import transformers

    text = {k: v for k, v in BASE.items() if k != "attn_implementation"}
    text["rope_scaling"] = {"rope_type": "default", "mrope_section": [1, 1, 2],
                            "mrope_interleaved": True}
    cfg = transformers.Qwen3VLConfig(
        text_config=text, vision_config=dict(depth=1, hidden_size=16, intermediate_size=32,
                                             num_heads=2, out_hidden_size=32))
    cfg.text_config._attn_implementation = "eager"
    torch.manual_seed(0)
    model = transformers.Qwen3VLTextModel(cfg.text_config).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape))
    return model, cfg.to_dict()


def test_qwen3_vl_text_tower_has_qk_norms_and_loads_them():
    """A tiny Qwen3VLConfig (its text config nested, model_type qwen3_vl)
    maps to qk_norm like Qwen3; its text tower, saved under
    model.language_model. beside a vision tower and a head, loads and
    matches transformers' Qwen3VLTextModel on text-only ids (interleaved
    MRoPE is plain RoPE there) within 1e-4 on the valid rows. A config that
    drops the q / k norms, or a stray key under the text prefix, raises
    naming the untaken keys; the non-weight rotary buffer does not."""
    model, hf_cfg = _qwen3_vl()
    assert hf_cfg["model_type"] == "qwen3_vl"
    tcfg = tllm.CausalLMConfig.from_hf_config(hf_cfg, dtype=torch.float32)
    assert tcfg.qk_norm and not tcfg.mrope_section
    sd = {"model.language_model." + k: v for k, v in model.state_dict().items()}
    sd["model.language_model.rotary_emb.inv_freq"] = torch.ones(4)
    sd["model.visual.patch_embed.proj.weight"] = torch.zeros(16, 3, 2, 16, 16)
    sd["lm_head.weight"] = torch.zeros(96, 32)
    prefix = tllm.detect_prefix(sd)
    assert prefix == "model.language_model."
    port = tllm.CausalLM(tcfg)
    port.load_state_dict(tllm.convert_hf_causal_lm(sd, tcfg, prefix=prefix))
    ids, mask = torch.from_numpy(IDS), torch.from_numpy(MASK)
    with torch.no_grad():
        got = port(ids, mask)[0]
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
    valid = MASK.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], want.numpy()[valid], atol=1e-4, rtol=1e-4)
    with pytest.raises(KeyError, match="q_norm"):
        tllm.convert_hf_causal_lm(sd, dataclasses.replace(tcfg, qk_norm=False), prefix=prefix)
    with pytest.raises(KeyError, match="does not take"):
        tllm.convert_hf_causal_lm({**sd, "model.language_model.layers.0.mlp.bias": torch.zeros(1)},
                                  tcfg, prefix=prefix)


def test_stacked_layer_states_match_jax():
    """stack_layers: [B, num_layers, S, dim], the JAX HiDream text
    function's hiddens[1:] stacked on axis 1 (2e-5, f32, the JAX CausalLM
    compiled once with the Llama case above)."""
    model, hf_cfg = hf_model("llama")
    tcfg = tllm.CausalLMConfig.from_hf_config(hf_cfg, dtype=torch.float32)
    jcfg = jllm.CausalLMConfig.from_hf_config(hf_cfg, dtype=jnp.float32)
    _, jh = _jax_lm(jcfg, jllm.convert_hf_causal_lm(model.state_dict(), jcfg, prefix=""),
                    jnp.asarray(IDS), jnp.asarray(MASK), None)
    enc = tllm.LLMTextEncoder(".", max_length=10, stack_layers=True, dtype=torch.float32)
    enc.model = tllm.CausalLM(tcfg)
    enc.model.load_state_dict(tllm.convert_hf_causal_lm(model.state_dict(), tcfg, prefix=""))
    with torch.no_grad():
        got = enc.hidden_states(torch.from_numpy(IDS), torch.from_numpy(MASK))
    want = np.stack([np.asarray(h) for h in jh[1:]], axis=1)
    assert got.shape == want.shape == (2, 2, 10, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_llama31_encoder_pads_with_eos_and_stacks_layers(tmp_path):
    """A Llama-3.1 folder whose tokenizer has no pad token (as Llama 3.1's
    has none): LLMTextEncoder pads with EOS, and stack_layers gives
    transformers' hidden_states[1:] stacked on axis 1 (1e-4 on the valid
    rows, f32, eager attention); fp8 storage (llama3_4bit) keeps the shape."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from diffusion_pipe_tpu_torch import safetensors_io

    words = ["<unk>", "<|begin_of_text|>", "<|eot_id|>", "a", "red", "cat", "dog"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                   eos_token="<|eot_id|>")
    assert fast.pad_token is None
    fast.save_pretrained(str(tmp_path))
    cfg = transformers.LlamaConfig(**LLAMA31)
    torch.manual_seed(2)
    model = transformers.LlamaModel(cfg).eval()
    (tmp_path / "config.json").write_text(json.dumps({**cfg.to_dict(), "model_type": "llama"},
                                                     default=str))
    safetensors_io.save_file({"model." + k: v.contiguous() for k, v in model.state_dict().items()},
                             str(tmp_path / "model.safetensors"))
    enc = tllm.LLMTextEncoder(str(tmp_path), max_length=6, stack_layers=True,
                              dtype=torch.float32)
    h, mask = enc.encode(["a red cat", "dog"])
    assert enc.tokenizer.pad_token == "<|eot_id|>"
    assert h.shape == (2, 2, 6, 256) and mask.tolist() == [[1] * 3 + [0] * 3, [1] + [0] * 5]
    ids = enc.tokenizer(["a red cat", "dog"], padding="max_length", max_length=6,
                        return_tensors="pt")["input_ids"]
    assert ids[1, 1:].eq(2).all()  # EOS pads
    with torch.no_grad():
        want = torch.stack(model(input_ids=ids, attention_mask=mask, output_hidden_states=True)
                           .hidden_states[1:], dim=1)
    valid = mask.bool()[:, None].expand(-1, 2, -1)
    np.testing.assert_allclose(h[valid].numpy(), want[valid].numpy(), atol=1e-4, rtol=1e-4)
    h8, _ = tllm.LLMTextEncoder(str(tmp_path), max_length=6, stack_layers=True, fp8=True,
                                dtype=torch.float32).encode(["a red cat", "dog"])
    assert h8.shape == h.shape and torch.isfinite(h8).all()
