"""The port's Flux weight conversion and LoRA export/import
(models/flux_convert.py) against the JAX package's, on tiny Flux.

- convert_diffusers_flux on a synthetic diffusers checkpoint (every key the
  JAX converter reads, random values) equals interop of the JAX result, key
  for key and bit for bit; convert_bfl_flux on the same weights fused into
  the BFL layout gives the same state dict in both packages, and the same
  as the diffusers conversion.
- export_lora_diffusers of the same LoRA factors gives the JAX export's keys
  and bits; the port's exported file loads through the JAX
  import_lora_diffusers into the exported factors, and the JAX export loads
  through the port's import_lora_diffusers.
- the pipeline's save_adapter / load_adapter round trip, and the
  merge_adapters fusion of a LoRA file into a raw state dict against the
  JAX function.
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file

from diffusion_pipe_tpu.models import flux_convert as jconv
from diffusion_pipe_tpu.models import get_model_class as jax_model_class
from diffusion_pipe_tpu.models.weights import merge_adapters_into_state_dict as jmerge
from diffusion_pipe_tpu.training.train_state import lora_predicate as jax_lora
from diffusion_pipe_tpu.training.train_state import partition_params
from diffusion_pipe_tpu_torch import safetensors_io
from diffusion_pipe_tpu_torch.interop import jax_to_state_dict
from diffusion_pipe_tpu_torch.models import flux_convert as pconv
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.models.weights import merge_adapters_into_state_dict as pmerge
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import random_params, tiny_flux_config

CFG = tiny_flux_config()


@pytest.fixture(scope="module")
def pipes():
    return jax_model_class("flux")(CFG), get_model_class("flux")(CFG, device="cpu")


def _diffusers_checkpoint(jpipe, ppipe, seed=0):
    """Every key the JAX converter reads, shaped as the port's parameter of
    the same weight, random values."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in ppipe.model.state_dict().items()}
    cfg = jpipe.flux_config
    pairs = [(ours, theirs) for ours, theirs in pconv._TOP.items()]
    pairs += [(o, t) for o, t in pconv._GUIDANCE.items()]
    for i in range(cfg.num_layers):
        pairs += [(f"double_blocks.{i}.{o}", f"transformer_blocks.{i}.{t}")
                  for o, t in jconv._DOUBLE_MAP.items()]
    for i in range(cfg.num_single_layers):
        pairs += [(f"single_blocks.{i}.{o}", f"single_transformer_blocks.{i}.{t}")
                  for o, t in jconv._SINGLE_MAP.items()]
    sd = {}
    for ours, theirs in pairs:
        sd[f"{theirs}.weight"] = rng.standard_normal(shapes[f"{ours}.weight"]).astype(np.float32)
        sd[f"{theirs}.bias"] = rng.standard_normal(shapes[f"{ours}.bias"]).astype(np.float32)
    norms = [(f"double_blocks.{i}.{o}", f"transformer_blocks.{i}.{t}")
             for i in range(cfg.num_layers) for o, t in jconv._DOUBLE_NORMS.items()]
    norms += [(f"single_blocks.{i}.{o}", f"single_transformer_blocks.{i}.{t}")
              for i in range(cfg.num_single_layers) for o, t in jconv._SINGLE_NORMS.items()]
    for ours, theirs in norms:
        sd[f"{theirs}.weight"] = rng.standard_normal(shapes[f"{ours}.scale"]).astype(np.float32)
    return sd


def _to_bfl(sd, cfg):
    """The same weights in the BFL single-file layout."""
    h = cfg.hidden_size
    out = {}
    top = {"time_in.in_layer": "time_text_embed.timestep_embedder.linear_1",
           "time_in.out_layer": "time_text_embed.timestep_embedder.linear_2",
           "vector_in.in_layer": "time_text_embed.text_embedder.linear_1",
           "vector_in.out_layer": "time_text_embed.text_embedder.linear_2",
           "guidance_in.in_layer": "time_text_embed.guidance_embedder.linear_1",
           "guidance_in.out_layer": "time_text_embed.guidance_embedder.linear_2",
           "txt_in": "context_embedder", "img_in": "x_embedder", "final_layer.linear": "proj_out"}
    for bfl, diff in top.items():
        for p in ("weight", "bias"):
            out[f"{bfl}.{p}"] = sd[f"{diff}.{p}"]
    for p in ("weight", "bias"):
        w = sd[f"norm_out.linear.{p}"]
        out[f"final_layer.adaLN_modulation.1.{p}"] = np.concatenate([w[h:], w[:h]])
    for i in range(cfg.num_layers):
        d, b = f"transformer_blocks.{i}", f"double_blocks.{i}"
        pairs = {"img_mod.lin": "norm1.linear", "txt_mod.lin": "norm1_context.linear",
                 "img_attn.proj": "attn.to_out.0", "txt_attn.proj": "attn.to_add_out",
                 "img_mlp.0": "ff.net.0.proj", "img_mlp.2": "ff.net.2",
                 "txt_mlp.0": "ff_context.net.0.proj", "txt_mlp.2": "ff_context.net.2"}
        for p in ("weight", "bias"):
            for bfl, diff in pairs.items():
                out[f"{b}.{bfl}.{p}"] = sd[f"{d}.{diff}.{p}"]
            out[f"{b}.img_attn.qkv.{p}"] = np.concatenate(
                [sd[f"{d}.attn.to_{x}.{p}"] for x in "qkv"])
            out[f"{b}.txt_attn.qkv.{p}"] = np.concatenate(
                [sd[f"{d}.attn.add_{x}_proj.{p}"] for x in "qkv"])
        for bfl, diff in {"img_attn.norm.query_norm": "attn.norm_q",
                          "img_attn.norm.key_norm": "attn.norm_k",
                          "txt_attn.norm.query_norm": "attn.norm_added_q",
                          "txt_attn.norm.key_norm": "attn.norm_added_k"}.items():
            out[f"{b}.{bfl}.scale"] = sd[f"{d}.{diff}.weight"]
    for i in range(cfg.num_single_layers):
        d, b = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        for p in ("weight", "bias"):
            out[f"{b}.modulation.lin.{p}"] = sd[f"{d}.norm.linear.{p}"]
            out[f"{b}.linear2.{p}"] = sd[f"{d}.proj_out.{p}"]
            out[f"{b}.linear1.{p}"] = np.concatenate(
                [sd[f"{d}.attn.to_{x}.{p}"] for x in "qkv"] + [sd[f"{d}.proj_mlp.{p}"]])
        out[f"{b}.norm.query_norm.scale"] = sd[f"{d}.attn.norm_q.weight"]
        out[f"{b}.norm.key_norm.scale"] = sd[f"{d}.attn.norm_k.weight"]
    return out


def _assert_same(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k


def test_convert_diffusers_and_bfl_match_jax(pipes):
    jpipe, ppipe = pipes
    sd = _diffusers_checkpoint(jpipe, ppipe)
    ref = jax_to_state_dict(jconv.convert_diffusers_flux(sd, jpipe.flux_config))
    ours = pconv.convert_diffusers_flux({k: torch.from_numpy(v) for k, v in sd.items()},
                                        ppipe.flux_config)
    _assert_same(ours, ref)
    bfl = _to_bfl(sd, jpipe.flux_config)
    ref_bfl = jax_to_state_dict(jconv.convert_bfl_flux(bfl, jpipe.flux_config))
    ours_bfl = pconv.convert_bfl_flux({k: torch.from_numpy(v) for k, v in bfl.items()},
                                      ppipe.flux_config)
    _assert_same(ours_bfl, ref_bfl)
    _assert_same(ours_bfl, ours)
    # the converted weights load into the port's model (adapter factors kept)
    ppipe.init_params(torch.Generator().manual_seed(0))
    from diffusion_pipe_tpu_torch.interop import load_state_dict

    load_state_dict(ppipe.model, ours, partial=True)


@pytest.fixture(scope="module")
def lora(pipes):
    jpipe, _ = pipes
    params = random_params(jpipe, seed=5, lora_b_std=0.1)
    trainable, _ = partition_params(params, jax_lora)
    return nn.unbox(trainable)


def test_export_matches_jax_and_loads_in_both(pipes, lora, tmp_path):
    jpipe, ppipe = pipes
    ref = jconv.export_lora_diffusers(lora, jpipe.flux_config)
    ours_trainable = jax_to_state_dict(lora)
    ours = pconv.export_lora_diffusers(ours_trainable, ppipe.flux_config)
    n_linears = 14 * jpipe.flux_config.num_layers + 6 * jpipe.flux_config.num_single_layers
    assert len(ref) == 2 * n_linears
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32 and ours[k].is_contiguous()
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)

    # the port's file through the JAX import
    ppipe.save_adapter(tmp_path, ours_trainable)
    f = tmp_path / "adapter_model.safetensors"
    fresh = random_params(jpipe, seed=9)
    loaded = jconv.import_lora_diffusers(np_load_file(str(f)), jpipe.flux_config, fresh)
    loaded_lora = nn.unbox(partition_params(loaded, jax_lora)[0])
    for path, v in jax.tree_util.tree_leaves_with_path(lora):
        got = loaded_lora
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(v), err_msg=str(path))

    # the JAX export through the port's import, and load_adapter of the port's file
    jfile = tmp_path / "jax" / "adapter_model.safetensors"
    jfile.parent.mkdir()
    np_save_file(ref, str(jfile))
    for got in (pconv.import_lora_diffusers(safetensors_io.load_file(jfile), ppipe.flux_config),
                ppipe.load_adapter(tmp_path)):
        _assert_same(got, ours_trainable)


def test_merge_adapters_matches_jax(pipes, lora, tmp_path):
    jpipe, ppipe = pipes
    sd = _diffusers_checkpoint(jpipe, ppipe, seed=1)
    adapter = jconv.export_lora_diffusers(lora, jpipe.flux_config)
    rank = CFG["adapter"]["rank"]
    adapter.update({k.replace(".lora_A.weight", ".alpha"): np.asarray(2.0 * rank, np.float32)
                    for k in list(adapter) if k.endswith("lora_A.weight")})
    np_save_file(adapter, str(tmp_path / "a.safetensors"))
    ref = jmerge(dict(sd), [str(tmp_path / "a.safetensors")])
    ours = pmerge({k: torch.from_numpy(v) for k, v in sd.items()}, [str(tmp_path / "a.safetensors")])
    assert ours.keys() == ref.keys()
    changed = 0
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), v, rtol=1e-6, atol=1e-6, err_msg=k)
        changed += int(not np.array_equal(v, sd[k]))
    assert changed == len(adapter) * 2 // 3 // 2
