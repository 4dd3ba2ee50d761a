"""The port's models/keymaps.py against the JAX package's, on the same
tensors.

For tiny Flux, SD3 (qk_norm off and on), Chroma and Qwen-Image: a torch-layout
checkpoint made by the JAX keymap_from_flax from seeded numpy weights
(tests/torch_port_helpers.py) loads through the port's
keymap_to_state_dict to exactly interop.jax_to_state_dict(keymap_to_flax(
checkpoint)), and the port's keymap_from_state_dict of the same weights
gives exactly the JAX keymap_from_flax's tensors. A synthetic KeyMap
holds every other kind of entry (raw tensors, sized and equal fused
splits inside and outside blocks, stacks, a Conv3d, a patch linear,
`.scale` norms, an index offset, passthrough tensors) to the same two
gates. The adapter exports (LoRA and LoKr, SD3 and Chroma; Qwen-Image's
LoRA under `diffusion_model.`) equal the JAX
export_lora_keymap's keys and bits, and also hold the LoKr factors that
the JAX export drops (a fused entry's, and SD3's final block's, which is
a top-level linear there); every exported factor comes back through the
import bit for bit, fused pairs included. Flux's full fine-tuning export
equals the JAX save_model's file, and each package loads the other's.

The layout comes from the checkpoint: a Flux file with other block
counts, and an SD3.5-layout file (3 blocks, qk_norm, another position
table), against the JAX SD3Config of that layout; SD3.5 Medium's attn2
blocks raise.

Defect of the JAX package held here: its fused LoRA pairs, of rank n * r,
are written with the trained alpha, so a loader scaling by alpha / rank
applies 1/n of the trained delta; the port's file gives the trained
delta. A second one: the JAX fused lora_A is a Fortran-ordered array,
which the safetensors package writes scrambled. Every comparison is bit
for bit except the merged deltas (1e-6 relative: two f32 matmul
orders).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models import keymaps as jkm
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models import keymaps as tkm
from diffusion_pipe_tpu_torch.models.weights import merge_adapters_into_state_dict
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import random_params

CASES = ["flux", "sd3", "sd3_qk_norm", "chroma", "qwen_image"]


def _config(family, adapter=None):
    cfg = {"save_every_n_epochs": 1,
           "model": {"type": family, "dtype": "float32", "_tiny": True},
           "optimizer": {"type": "adamw", "lr": 1e-4}}
    if adapter:
        cfg["adapter"] = {"type": adapter, "rank": 4, "alpha": 8, "dropout": 0.0}
    return cfg


def _pipelines(case, adapter=None):
    """(JAX pipeline, port pipeline) of a case; SD3's qk_norm set on both
    (neither pipeline reads it from the config)."""
    family = "sd3" if case == "sd3_qk_norm" else case
    cfg = _config(family, adapter)
    jp = jax_model_class(family)(cfg)
    tp = get_model_class(family)(cfg, device="cpu")
    if case == "sd3_qk_norm":
        from diffusion_pipe_tpu.models.sd3_model import SD3Transformer as JaxSD3
        from diffusion_pipe_tpu_torch.models.sd3_model import SD3Transformer

        jp.sd3_config = dataclasses.replace(jp.sd3_config, qk_norm=True)
        jp.model = JaxSD3(jp.sd3_config)
        tp.sd3_config = dataclasses.replace(tp.sd3_config, qk_norm=True)
        with torch.device("meta"):
            tp.model = SD3Transformer(tp.sd3_config)
    return jp, tp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, v in want.items():
        w = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


@pytest.mark.parametrize("case", CASES)
def test_keymap_load_and_export_match_jax(case):
    """Load: keymap_to_state_dict(ckpt) == jax_to_state_dict(
    keymap_to_flax(ckpt)); export: keymap_from_state_dict(weights) ==
    keymap_from_flax(weights); the port's weights load into its model."""
    jp, tp = _pipelines(case)
    params = random_params(jp, seed=1)
    km, jcfg = jp.keymap(), jp._keymap_config()
    ckpt = jkm.keymap_from_flax(_np(params), km, jcfg)
    port_ckpt = tkm.keymap_from_state_dict(jax_to_state_dict(params), tp.keymap(),
                                           tp._keymap_config())
    _assert_same(port_ckpt, ckpt)
    loaded = tkm.keymap_to_state_dict({k: torch.from_numpy(v) for k, v in ckpt.items()},
                                      tp.keymap(), tp._keymap_config())
    _assert_same(loaded, jax_to_state_dict(jkm.keymap_to_flax(ckpt, km, jcfg)))
    model_keys = {k for k in tp.model.state_dict() if "lora" not in k}
    assert set(loaded) == model_keys


def _synthetic_keymap(km_module):
    """A KeyMap with every kind of entry; block counts from a config."""
    bg = km_module.BlockGroup(
        "blocks", "layers", "n", offset=2,
        linears={"attn/q": "attn.q", "mlp_out": "mlp.fc2"},
        norms={"norm_q": "attn.norm_q"},
        raw={"table": "scale_shift_table"},
        fused={"qkv": ("a_k", "a_v"), "linear1": (("p", 6), ("m", 10))},
        stacks={"experts": ("experts.{}", 3)},
        norm_suffix="scale")
    return km_module.KeyMap(
        blocks=[bg],
        top_linears={"emb/linear_1": "time_embed.linear_1"},
        top_norms={"final_norm": "norm_out"},
        top_raw={"pos": "pos_table"},
        top_convs={"patch3d": "patch_embedding"},
        top_patch_linears={"patch2d": "pos_embed.proj"},
        patch_linear_shapes={"patch2d": (3, 2, 2)},
        top_fused={"head.qkv": ("head/q", "head/k")},
        top_stacks={"banks": ("bank.{}", "n_banks")},
        passthrough_patterns=(r"^audio\.",),
    )


class _Cfg:
    n = 2
    n_banks = 2


def _synthetic_checkpoint(seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"time_embed.linear_1.weight": r(8, 4), "time_embed.linear_1.bias": r(8),
          "norm_out.weight": r(8), "pos_table": r(5, 8),
          "patch_embedding.weight": r(8, 3, 1, 2, 2), "patch_embedding.bias": r(8),
          "pos_embed.proj.weight": r(8, 3, 2, 2), "pos_embed.proj.bias": r(8),
          "head.qkv.weight": r(8, 8), "head.qkv.bias": r(8),
          "bank.0.weight": r(8, 8), "bank.1.weight": r(8, 8)}
    for i in (2, 3):
        p = f"layers.{i}."
        sd.update({p + "attn.q.weight": r(8, 8), p + "attn.q.bias": r(8),
                   p + "mlp.fc2.weight": r(8, 8), p + "attn.norm_q.scale": r(8),
                   p + "scale_shift_table": r(1, 6, 8),
                   p + "qkv.weight": r(16, 8), p + "qkv.bias": r(16),
                   p + "linear1.weight": r(16, 8),
                   **{p + f"experts.{j}.weight": r(8, 8) for j in range(3)}})
    return sd


def test_every_kind_of_entry_matches_jax(tmp_path):
    """The synthetic KeyMap: the load and export gates, the round trip, and
    passthrough tensors kept at load and written back by save_model."""
    ckpt = _synthetic_checkpoint()
    jkmap, tkmap = _synthetic_keymap(jkm), _synthetic_keymap(tkm)
    want = jax_to_state_dict(jkm.keymap_to_flax(ckpt, jkmap, _Cfg))
    got = tkm.keymap_to_state_dict({"diffusion_model." + k: torch.from_numpy(v)
                                    for k, v in ckpt.items()}, tkmap, _Cfg)
    _assert_same(got, want)
    back = tkm.keymap_from_state_dict(got, tkmap, _Cfg)
    _assert_same(back, jkm.keymap_from_flax(jkm.keymap_to_flax(ckpt, jkmap, _Cfg), jkmap, _Cfg))
    _assert_same(back, ckpt)

    from diffusion_pipe_tpu_torch.models.base import BasePipeline

    class Stub(BasePipeline):
        name = "stub"

        def keymap(self):
            return tkmap

        def _keymap_config(self):
            return _Cfg

    full = {**ckpt, "audio.proj.weight": np.ones((2, 2), np.float32)}
    safetensors_io.save_file({"model.diffusion_model." + k: v for k, v in full.items()},
                             tmp_path / "ckpt.safetensors")
    pipe = Stub({"model": {"ckpt_path": str(tmp_path / "ckpt.safetensors")}}, device="cpu")
    sd = tkm.load_sd_for_pipeline(pipe)
    assert set(pipe._passthrough_sd) == {"audio.proj.weight"} and "audio.proj.weight" not in sd
    weights = tkm.keymap_to_state_dict(sd, tkmap, _Cfg)
    pipe.save_model(tmp_path / "out", types.SimpleNamespace(state_dict=lambda: weights))
    _assert_same(safetensors_io.load_file(tmp_path / "out" / "model.safetensors"),
                 {k: torch.from_numpy(v) for k, v in full.items()})


def _trainable(jp, seed):
    params = random_params(jp, seed=seed, lora_b_std=0.05)
    trainable, _ = partition_params(params, jax_lora)
    return _np(trainable)


@pytest.mark.parametrize("case,adapter", [("sd3", "lora"), ("chroma", "lora"),
                                          ("sd3", "lokr"), ("chroma", "lokr"),
                                          ("qwen_image", "lora")])
def test_adapter_export_matches_jax_and_round_trips(case, adapter, tmp_path):
    """The port's export of the same factors: the JAX export's keys and bits,
    and the LoKr factors that the JAX export drops (a fused entry's, out
    per part; a top-level linear's: SD3's final block); saved and imported
    back, every factor bit for bit; the alpha entries keep alpha / rank at
    the trained value."""
    jp, tp = _pipelines(case, adapter)
    trainable = _trainable(jp, seed=2)
    factors = jax_to_state_dict(trainable)
    want = jkm.export_lora_keymap(trainable, jp.keymap(), jp._keymap_config())
    got = tkm.export_lora_keymap(factors, tp.keymap(), tp._keymap_config())
    extra = {k for k in got if k not in want}
    last = f"transformer.transformer_blocks.{tp._keymap_config().num_layers - 1}."
    assert all(".lokr_" in k and (k.startswith(last) if case == "sd3" else
                                  (".qkv." in k or ".linear1." in k)) for k in extra)
    assert bool(extra) == (adapter == "lokr")
    _assert_same({k: v for k, v in got.items() if k in want}, want)
    tp.save_adapter(tmp_path, factors)
    saved = safetensors_io.load_file(tmp_path / "adapter_model.safetensors")
    for k, a in saved.items():
        if k.endswith(".lora_A.weight"):
            alpha = saved[k[:-len("lora_A.weight")] + "alpha"].item()
            assert alpha / a.shape[0] == 8 / 4, k
    back = tp.load_adapter(tmp_path)
    _assert_same(back, factors)


def test_fused_lora_delta_under_alpha_over_rank(tmp_path):
    """A loader that scales each pair by alpha / rank (the port's
    merge_adapters_into_state_dict, as ComfyUI and kohya do) merges the
    trained delta from the port's Chroma file, sum over parts of (alpha /
    r) B_j A_j on the fused rows, and a third of it from the JAX
    package's (qkv: n = 3), a quarter on linear1 (n = 4). The JAX package's
    own file also holds each fused lora_A scrambled (see below)."""
    jp, tp = _pipelines("chroma", "lora")
    trainable = _trainable(jp, seed=3)
    factors = jax_to_state_dict(trainable)
    sd = tkm.export_lora_keymap(factors, tp.keymap(), tp._keymap_config())
    tkm.save_lora_safetensors(tmp_path / "port", sd, alpha=8.0, rank=4)
    jax_sd = jkm.export_lora_keymap(trainable, jp.keymap(), jp._keymap_config())
    # the JAX fused lora_A is a Fortran-ordered array, which the safetensors
    # package writes in memory order under a C-order header: the file holds
    # it scrambled. Written C-ordered, the alpha alone is at fault.
    jkm.save_lora_safetensors(tmp_path / "jax_as_is", jax_sd, alpha=8.0)
    fused_a = "diffusion_model.double_blocks.0.img_attn.qkv.lora_A.weight"
    as_is = safetensors_io.load_file(tmp_path / "jax_as_is" / "adapter_model.safetensors")
    assert not jax_sd[fused_a].flags["C_CONTIGUOUS"]
    assert not np.array_equal(as_is[fused_a].numpy(), jax_sd[fused_a])
    jkm.save_lora_safetensors(tmp_path / "jax", {k: np.ascontiguousarray(v)
                                                 for k, v in jax_sd.items()}, alpha=8.0)
    dim, mlp = tp.chroma_config.hidden_size, tp.chroma_config.mlp_dim
    bases = {"double_blocks.0.img_attn.qkv.weight": (3 * dim, ["attn_to_q", "attn_to_k",
                                                               "attn_to_v"]),
             "single_blocks.1.linear1.weight": (3 * dim + mlp, ["attn_to_q", "attn_to_k",
                                                                "attn_to_v", "proj_mlp"])}
    zeros = {k: torch.zeros(rows, dim) for k, (rows, _) in bases.items()}
    for key, (rows, parts) in bases.items():
        block = ".".join(key.split(".")[:2]) + "."
        trained = torch.cat([(8 / 4) * (factors[block + p + ".lora_b"].t()
                                         @ factors[block + p + ".lora_a"].t()) for p in parts])
        port = merge_adapters_into_state_dict(dict(zeros), [tmp_path / "port"])[key]
        jax_delta = merge_adapters_into_state_dict(dict(zeros), [tmp_path / "jax"])[key]
        np.testing.assert_allclose(port.numpy(), trained.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(jax_delta.numpy(), trained.numpy() / len(parts), rtol=1e-6,
                                   atol=1e-7)


def test_import_refuses_a_fused_pair_that_does_not_split(tmp_path):
    """A fused lora_B with an entry outside its rank blocks (a pair trained
    on the fused weight, not per part) raises, naming the key."""
    jp, tp = _pipelines("chroma", "lora")
    factors = jax_to_state_dict(_trainable(jp, seed=4))
    sd = tkm.export_lora_keymap(factors, tp.keymap(), tp._keymap_config())
    key = "diffusion_model.single_blocks.0.linear1.lora_B.weight"
    sd[key][0, -1] = 0.5
    tkm.save_lora_safetensors(tmp_path, sd, alpha=8.0, rank=4)
    with pytest.raises(ValueError, match=r"single_blocks\.0\.linear1: lora_B is not block-diag"):
        tp.load_adapter(tmp_path)


def test_flux_save_model_matches_jax_and_loads_across(tmp_path):
    """Full fine-tuning export of tiny Flux in the diffusers layout: the
    port's model.safetensors holds the JAX save_model's keys and bits;
    each package's load_weights reads the other's file back to the same
    weights."""
    jp, tp = _pipelines("flux")
    params = random_params(jp, seed=5)
    jp.save_model(tmp_path / "jax", params)
    tp.init_params(torch.Generator().manual_seed(0))
    tp.model.load_state_dict(jax_to_state_dict(params))
    tp.save_model(tmp_path / "port", tp.model)
    port_file = safetensors_io.load_file(tmp_path / "port" / "model.safetensors")
    _assert_same(port_file, safetensors_io.load_file(tmp_path / "jax" / "model.safetensors"))
    assert safetensors_io.metadata((tmp_path / "port" / "model.safetensors").read_bytes()) == {
        "format": "pt"}

    tp.model_config["transformer_path"] = str(tmp_path / "jax" / "model.safetensors")
    _assert_same(tp.load_weights(), jax_to_state_dict(params))
    jp.model_config["transformer_path"] = str(tmp_path / "port" / "model.safetensors")
    _assert_same(jax_to_state_dict(jp.load_weights()), jax_to_state_dict(params))


@pytest.mark.parametrize("case", ["from_checkpoint", "model_config_disagrees"])
def test_flux_block_counts_come_from_the_checkpoint(tmp_path, case):
    """A diffusers Flux checkpoint with 3 double and 1 single block (as Flex
    or another variant has other counts): load_weights rebuilds the tiny
    model (2 + 2) on those counts and every tensor lands; a [model]
    num_layers that disagrees with the file raises."""
    src = get_model_class("flux")(dict(_config("flux"), model=dict(
        _config("flux")["model"], num_layers=3, num_single_layers=1)), device="cpu")
    src.init_params(torch.Generator().manual_seed(0))
    src.save_model(tmp_path, src.model)
    mc = dict(_config("flux")["model"], transformer_path=str(tmp_path / "model.safetensors"))
    if case == "model_config_disagrees":
        mc["num_layers"] = 2
    tp = get_model_class("flux")(dict(_config("flux"), model=mc), device="cpu")
    assert (tp.flux_config.num_layers, tp.flux_config.num_single_layers) == (2, 2)
    if case == "model_config_disagrees":
        with pytest.raises(KeyError, match="model.num_layers = 2 but the checkpoint holds 3"):
            tp.load_weights()
        return
    sd = tp.load_weights()
    assert (tp.flux_config.num_layers, tp.flux_config.num_single_layers) == (3, 1)
    tp.init_params(torch.Generator().manual_seed(1))
    tp.model.load_state_dict(sd, strict=False)
    _assert_same(tp.model.state_dict(), src.model.state_dict())


@pytest.fixture(scope="module")
def sd35_checkpoint():
    """A tiny SD3.5-layout checkpoint from the JAX SD3Config(num_layers=3,
    qk_norm=True, pos_embed_max_size=24) through the JAX keymap_from_flax,
    with diffusers' position-table buffer; the JAX pipeline and weights."""
    from diffusion_pipe_tpu.models.sd3_model import SD3Transformer as JaxSD3
    from diffusion_pipe_tpu_torch.models.sd3_model import sincos_2d_pos_embed

    jp = jax_model_class("sd3")(_config("sd3"))
    jp.sd3_config = dataclasses.replace(jp.sd3_config, num_layers=3, qk_norm=True,
                                        pos_embed_max_size=24)
    jp.model = JaxSD3(jp.sd3_config)
    params = random_params(jp, seed=7)
    ckpt = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jkm.keymap_from_flax(
        _np(params), jp.keymap(), jp._keymap_config()).items()}
    hidden = jp.sd3_config.hidden_size
    ckpt["pos_embed.pos_embed"] = torch.from_numpy(sincos_2d_pos_embed(hidden, 24, 8))[None]
    return jp, params, ckpt


@pytest.mark.parametrize("case", ["sd35_layout", "attn2"])
def test_sd3_layout_comes_from_the_checkpoint(tmp_path, sd35_checkpoint, case):
    """The tiny SD3 pipeline (2 blocks, no qk_norm, a 32-wide table) reads
    the checkpoint's 3 blocks, qk_norm and 24-wide table, and computes
    what the JAX SD3Config(num_layers=3, qk_norm=True) does (its submodules
    composed with one SiLU, torch_port_helpers.sd3_one_silu) within 1e-4;
    an SD3.5 Medium-style attn2 block raises, naming its keys."""
    from torch_port_helpers import sd3_one_silu

    jp, params, ckpt = sd35_checkpoint
    if case == "attn2":
        ckpt = {**ckpt, "transformer_blocks.0.attn2.to_q.weight": torch.zeros(64, 64)}
    safetensors_io.save_file(ckpt, tmp_path / "sd35.safetensors")
    tp = get_model_class("sd3")(dict(_config("sd3"), model=dict(
        _config("sd3")["model"], transformer_path=str(tmp_path / "sd35.safetensors"))),
        device="cpu")
    assert (tp.sd3_config.num_layers, tp.sd3_config.qk_norm) == (2, False)
    if case == "attn2":
        with pytest.raises(NotImplementedError, match=r"attn2.*transformer_blocks\.0\.attn2"):
            tp.load_weights()
        return
    sd = tp.load_weights()
    c = tp.sd3_config
    assert (c.num_layers, c.num_attention_heads, c.qk_norm, c.pos_embed_max_size) == (
        3, 4, True, 24)
    tp.init_params(torch.Generator().manual_seed(0))
    tp.model.load_state_dict(sd, strict=False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    t = np.array([300.0, 700.0], np.float32)
    txt = rng.standard_normal((2, 12, 64)).astype(np.float32)
    pooled = rng.standard_normal((2, 32)).astype(np.float32)
    want = jax.jit(lambda p, *a: sd3_one_silu(jp.model, p, *a))(params, x, t, txt, pooled)
    with torch.no_grad():
        got = tp.model(*(torch.from_numpy(a) for a in (x, t, txt, pooled)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
