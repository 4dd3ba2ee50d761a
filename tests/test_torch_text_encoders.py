"""The port's text encoders (models/text_encoders.py, transformers' torch
classes) on tiny random models saved to disk with a word-level tokenizer.

T5: the port's embeddings against the JAX package's HFTextEncoder (the
Flax T5 loaded from the same files), f32, within 1e-5 of the largest
magnitude (measured 6e-7). CLIP: the JAX package's Flax CLIP call does not
run with this transformers version (its module asks for position_ids), so
the port's pooled and last hidden states are held against
transformers' CLIPTextModel run directly on the same padded tokens, bit
for bit. A "t5" folder whose config names umt5 (Pile-T5, AuraFlow's text
encoder) loads transformers' UMT5 encoder, the same bits as that encoder
run directly.
"""

import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models.text_encoders import HFTextEncoder as JaxEncoder
from diffusion_pipe_tpu_torch.models.text_encoders import HFTextEncoder
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE

CAPTIONS = ["a photo of cat", "dog b c"]
WORDS = ["<pad>", "</s>", "<unk>", "a", "b", "c", "cat", "dog", "photo", "of"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import (CLIPTextConfig, CLIPTextModel, PreTrainedTokenizerFast, T5Config,
                              T5EncoderModel, UMT5Config, UMT5EncoderModel)

    root = tmp_path_factory.mktemp("te")
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(root / "tok")
    torch.manual_seed(0)
    T5EncoderModel(T5Config(vocab_size=len(WORDS), d_model=16, d_kv=4, d_ff=32, num_layers=2,
                            num_heads=4, relative_attention_num_buckets=8, pad_token_id=0,
                            eos_token_id=1, decoder_start_token_id=0)).save_pretrained(root / "t5")
    UMT5EncoderModel(UMT5Config(vocab_size=len(WORDS), d_model=16, d_kv=4, d_ff=32, num_layers=2,
                                num_heads=4, relative_attention_num_buckets=8, pad_token_id=0,
                                eos_token_id=1, decoder_start_token_id=0)).save_pretrained(
        root / "umt5")
    CLIPTextModel(CLIPTextConfig(vocab_size=len(WORDS), hidden_size=16, intermediate_size=32,
                                 num_hidden_layers=2, num_attention_heads=4,
                                 max_position_embeddings=8, pad_token_id=0, eos_token_id=1,
                                 bos_token_id=2)).save_pretrained(root / "clip")
    return root


def test_t5_matches_jax(models, monkeypatch):
    """The JAX encoder's jit compiles with JAX_FAST_COMPILE, and the Flax
    model's random init, which from_pretrained replaces by the loaded
    weights, runs in one jit (op by op it compiles every op)."""
    import functools

    import jax
    from transformers import FlaxT5EncoderModel

    init_weights = FlaxT5EncoderModel.init_weights

    def jitted_init_weights(self, rng, input_shape, params=None):
        return jax.jit(lambda r: init_weights(self, r, input_shape, params),
                       compiler_options=JAX_FAST_COMPILE)(rng)

    monkeypatch.setattr(FlaxT5EncoderModel, "init_weights", jitted_init_weights)
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE))
    ref = np.asarray(JaxEncoder("t5", str(models / "t5"), 8,
                                tokenizer_path=str(models / "tok")).encode(CAPTIONS))
    ours = HFTextEncoder("t5", str(models / "t5"), 8, tokenizer_path=str(models / "tok"),
                         device="cpu").encode(CAPTIONS)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape == (2, 8, 16)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["clip", "clip_pooled"])
def test_clip_matches_transformers(models, kind):
    from transformers import AutoTokenizer, CLIPTextModel

    ours = HFTextEncoder(kind, str(models / "clip"), 8, tokenizer_path=str(models / "tok"),
                         device="cpu").encode(CAPTIONS)
    tok = AutoTokenizer.from_pretrained(models / "tok")(
        CAPTIONS, padding="max_length", truncation=True, max_length=8, return_tensors="pt")
    with torch.no_grad():
        out = CLIPTextModel.from_pretrained(models / "clip")(
            input_ids=tok["input_ids"], attention_mask=tok["attention_mask"])
    ref = out.pooler_output if kind == "clip_pooled" else out.last_hidden_state
    assert torch.equal(ours, ref)


def test_umt5_folder_loads_umt5(models):
    from transformers import AutoTokenizer, UMT5EncoderModel

    enc = HFTextEncoder("t5", str(models / "umt5"), 8, tokenizer_path=str(models / "tok"),
                        device="cpu")
    ours = enc.encode(CAPTIONS)
    assert isinstance(enc._model, UMT5EncoderModel)
    tok = AutoTokenizer.from_pretrained(models / "tok")(
        CAPTIONS, padding="max_length", truncation=True, max_length=8, return_tensors="pt")
    with torch.no_grad():
        ref = UMT5EncoderModel.from_pretrained(models / "umt5")(
            input_ids=tok["input_ids"], attention_mask=tok["attention_mask"]).last_hidden_state
    assert torch.equal(ours, ref)


def test_t5_fp8_storage(models):
    """text_encoder_fp8: every T5 linear but the feed-forward's `wo` (which
    T5 keeps in f32) holds its weight in float8_e4m3fn and computes with it
    cast to the input's dtype, so the states are those of the model whose
    linear weights are rounded through float8; the relative-position table
    and the embedding keep their dtype."""
    from transformers import AutoTokenizer, T5EncoderModel

    enc = HFTextEncoder("t5", str(models / "t5"), 8, tokenizer_path=str(models / "tok"),
                        device="cpu", fp8=True)
    ours = enc.encode(CAPTIONS)
    weights = {n: p.dtype for n, p in enc._model.named_parameters()}
    assert weights["encoder.block.0.layer.0.SelfAttention.q.weight"] == torch.float8_e4m3fn
    assert weights["encoder.block.1.layer.1.DenseReluDense.wi.weight"] == torch.float8_e4m3fn
    assert weights["encoder.block.1.layer.1.DenseReluDense.wo.weight"] == torch.float32
    assert weights["shared.weight"] == torch.float32
    ref_model = T5EncoderModel.from_pretrained(models / "t5")
    with torch.no_grad():
        for name, m in ref_model.named_modules():
            if isinstance(m, torch.nn.Linear) and not name.endswith(".wo"):
                m.weight.copy_(m.weight.to(torch.float8_e4m3fn).float())
        tok = AutoTokenizer.from_pretrained(models / "tok")(
            CAPTIONS, padding="max_length", truncation=True, max_length=8, return_tensors="pt")
        ref = ref_model(input_ids=tok["input_ids"],
                        attention_mask=tok["attention_mask"]).last_hidden_state
    assert torch.equal(ours, ref)
