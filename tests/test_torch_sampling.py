"""The Euler flow sampler, --test_sample and --dump_dataset of the port
against the JAX package.

- flow_sigmas without and with shift: within 1e-6 relative (torch's and
  jnp's linspace round the same f32 grid in another order);
- euler_flow_sample with classifier-free guidance (scale 4) and a shift,
  on velocity functions linear in x and t written in both frameworks:
  within 1e-6 of the largest magnitude;
- FluxPipeline.sample and WanPipeline.sample against the JAX pipelines
  are held in test_torch_lokr.py, on its tiny LoKr models, whose JAX
  reference computes the sample in the same compile as the gradients;
- the driver with --dump_dataset writes one PNG per cached example (up to
  16 a bucket) at the bucket's size and stops, and with --test_sample
  writes output_dir/example.png of a 512 x 512 sample before it trains
  (tiny Flux, and tiny Wan from a video latent's first frame).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.training import sampling as jsampling
from diffusion_pipe_tpu_torch import train
from diffusion_pipe_tpu_torch.training.sampling import euler_flow_sample, flow_sigmas
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import JAX_FAST_COMPILE


@pytest.mark.parametrize("n, shift", [(10, None), (7, 3.0)])
def test_flow_sigmas_match(n, shift):
    np.testing.assert_allclose(flow_sigmas(n, shift).numpy(),
                               np.asarray(jsampling.flow_sigmas(n, shift)), rtol=1e-6, atol=0)


def test_euler_cfg_matches_jax():
    rng = np.random.default_rng(2)
    a, c, d = (rng.standard_normal((2, 3, 4, 4)).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(1)

    def jvel(w):
        return lambda x, t: jnp.asarray(w) * x + t[:, None, None, None] * jnp.asarray(c)

    def tvel(w):
        return lambda x, t: torch.from_numpy(w) * x + t[:, None, None, None] * torch.from_numpy(c)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def run(key):
        """The sample and its initial noise (one compile for both)."""
        return (jsampling.euler_flow_sample(jvel(a), (2, 3, 4, 4), key, num_steps=5,
                                            guidance_scale=4.0, uncond_velocity_fn=jvel(d),
                                            shift=3.0),
                jax.random.normal(key, (2, 3, 4, 4), jnp.float32))

    want, noise = run(key)
    want, noise = np.asarray(want), torch.tensor(np.asarray(noise))
    got = euler_flow_sample(tvel(a), (2, 3, 4, 4), num_steps=5, guidance_scale=4.0,
                            uncond_velocity_fn=tvel(d), shift=3.0, noise=noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


# --- the driver -------------------------------------------------------------------

CONFIG = """output_dir = "{out}"
dataset = "{root}/dataset.toml"
epochs = 1
micro_batch_size_per_gpu = 2
save_every_n_epochs = 1
eval_before_first_step = false
sample_steps = 2

[model]
type = "{family}"
dtype = "float32"
_tiny = true

[adapter]
type = "lokr"
rank = 4

[optimizer]
type = "adamw8bit"
lr = 1e-3
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("sample_cli")
    (root / "train").mkdir()
    for i in range(6):
        rng = np.random.default_rng(i)
        w, h = (64, 64) if i % 3 else (96, 48)
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            root / "train" / f"im{i}.png")
        (root / "train" / f"im{i}.txt").write_text(f"picture {i}")
    (root / "dataset.toml").write_text(
        'resolutions = [64]\nenable_ar_bucket = true\nnum_ar_buckets = 3\n'
        f'[[directory]]\npath = "{root}/train"\n')
    return root


@pytest.mark.parametrize("family", ["flux", "wan"])
def test_driver_dump_dataset_and_test_sample(root, family, monkeypatch):
    from PIL import Image

    monkeypatch.setitem(sys.modules, "tensorboard", None)
    cfg = root / f"{family}.toml"
    cfg.write_text(CONFIG.format(out=root / f"out_{family}", root=root, family=family))
    dump = root / f"dump_{family}"
    assert train.main(["--config", str(cfg), "--device", "cpu", "--dump_dataset", str(dump)]) == 0
    pngs = sorted(dump.glob("img_*.png"))
    assert len(pngs) == 6
    # the two aspect buckets at resolution 64
    assert {Image.open(p).size for p in pngs} == {(64, 64), (96, 32)}
    assert not (root / f"out_{family}").exists()  # it stopped after the caching phase

    assert train.main(["--config", str(cfg), "--device", "cpu", "--test_sample", "a cat",
                       "--max_steps", "1"]) == 0
    example = root / f"out_{family}" / "example.png"
    img = Image.open(example)
    # a 512 px sample: 64 x 64 latents, which the tiny Wan VAE (two
    # spatial stages) decodes to 256 px
    assert img.size == ((512, 512) if family == "flux" else (256, 256)) and img.mode == "RGB"
    assert np.asarray(img).std() > 0
