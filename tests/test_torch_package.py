"""Package rules of the port (diffusion_pipe_tpu_torch).

- no module imports jax, flax, optax or the JAX package (checked on the AST),
  nor do chip_smoke.py and tools/profile_torch_step.py;
- importing every module needs neither nvcc nor triton, nor Pillow,
  safetensors, transformers, tensorboard or imageio (the H100 machine may
  lack them);
- an entry point raises when CUDA is absent and the caller did not pass
  device="cpu";
- the port's config loader gives the JAX package's result on the example TOML.
"""

import ast
import copy
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from diffusion_pipe_tpu import config as jax_config
from diffusion_pipe_tpu_torch import config as port_config
from diffusion_pipe_tpu_torch.models import get_model_class
from diffusion_pipe_tpu_torch.training.optimizers import get_optimizer
from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
from diffusion_pipe_tpu_torch.training.trainer import init_train_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "diffusion_pipe_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "diffusion_pipe_tpu")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15 and all(
        PKG / f in files for f in ("models/hidream.py", "models/cosmos_predict2.py",
                                   "models/cosmos.py", "models/cosmos_tokenizer.py",
                                   "models/llm_adapter.py", "training/edm.py",
                                   "models/hunyuan_video_model.py", "models/hunyuan_video.py",
                                   "models/hunyuan_vae.py", "models/hunyuan_image.py",
                                   "models/hunyuan_video_15.py", "models/ltx_vae.py",
                                   "models/ltx_video.py", "models/ltx2.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_step.py",
              ROOT / "tools" / "run_smoke_phases.py"]
    for f in files:
        roots = set(_imported_roots(ast.parse(f.read_text(), str(f))))
        assert not roots & set(FORBIDDEN), (f, roots & set(FORBIDDEN))


# packages the H100 machine may lack: the port imports them where it uses them
CARD_OPTIONAL = ("triton", "PIL", "safetensors", "transformers", "tensorboard", "imageio")


def test_import_needs_no_nvcc_or_triton():
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {CARD_OPTIONAL!r}:\n"
        "    sys.modules[name] = None\n"  # any import of it now fails
        "import diffusion_pipe_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"save_every_n_epochs": 1,
           "model": {"type": "flux", "dtype": "float32", "_tiny": True}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model_class("flux")(cfg)
    pipe = get_model_class("flux")(cfg, device="cpu")
    assert pipe.device.type == "cpu"
    bypass = get_model_class("flux")(
        dict(cfg, model=dict(cfg["model"], bypass_guidance_embedding=True)), device="cpu")
    assert bypass.device.type == "cpu" and bypass._guidance(torch.ones(1)) is None


@pytest.mark.parametrize("family", ["hunyuan-video", "hunyuan_video", "hunyuan_image",
                                    "hunyuan_video_15", "hunyuan_video_1.5", "ltx-video",
                                    "ltx_video", "ltx2"])
def test_hunyuan_pipelines_need_cuda_or_an_explicit_cpu(monkeypatch, family):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"save_every_n_epochs": 1, "model": {"type": family, "dtype": "float32", "_tiny": True}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model_class(family)(cfg)
    assert get_model_class(family)(cfg, device="cpu").device.type == "cpu"


def test_config_matches_jax_package():
    toml = ROOT / "examples" / "flux.toml"
    ours = port_config.set_config_defaults(port_config.load_toml(str(toml)))
    ref = jax_config.set_config_defaults(jax_config.load_toml(str(toml)))
    assert ours == ref
    with pytest.raises(NotImplementedError):  # alpha is forced equal to rank
        port_config.set_config_defaults(
            copy.deepcopy(dict(ref, adapter={"type": "lora", "rank": 4, "alpha": 4})))


def test_train_state_uses_requires_grad():
    cfg = {"save_every_n_epochs": 1,
           "model": {"type": "flux", "dtype": "float32", "_tiny": True},
           "adapter": {"type": "lora", "rank": 2, "alpha": 2}}
    pipe = get_model_class("flux")(cfg, device="cpu")
    state = init_train_state(pipe, get_optimizer(cfg), torch.Generator().manual_seed(0),
                             lora_predicate)
    named = dict(pipe.model.named_parameters())
    assert set(state.trainable) == {n for n, p in named.items() if p.requires_grad}
    assert all(n.endswith(("lora_a", "lora_b")) for n in state.trainable)
    assert all(named[n].min() >= 0 for n in state.trainable if n.endswith("lora_a"))
    assert all(torch.all(named[n] == 0) for n in state.trainable if n.endswith("lora_b"))
