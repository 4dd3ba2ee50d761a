"""The port's safetensors reader and writer (diffusion_pipe_tpu_torch/
safetensors_io.py) against the `safetensors` package.

For every dtype the port reads and writes (F64, F32, F16, BF16, F8_E4M3,
F8_E5M2, I64, I32, I16, I8, U8, BOOL), alone and all in one file, with
0-d and empty tensors: the writer's bytes equal safetensors.torch.save's,
with no metadata, empty metadata and one metadata entry (the package orders
a larger metadata map at random); the reader gives the package's tensors,
dtype and bits, and the package reads the port's file. A file from
safetensors.numpy (how the JAX package's cache writes) reads too.
"""

import numpy as np
import pytest
import torch
from safetensors.numpy import save as np_save
from safetensors.torch import load as ref_load
from safetensors.torch import save as ref_save

from diffusion_pipe_tpu_torch import safetensors_io

DTYPES = list(safetensors_io.DTYPES.items())


def _tensor(dtype, shape, seed):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 40
    return (x > 0) if dtype == torch.bool else x.to(dtype)


def _bits(t):
    return t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else t


def _tensors(dtypes):
    out = {}
    for i, (name, dt) in enumerate(dtypes):
        out[f"w.{name}"] = _tensor(dt, (3, i + 2), i)
        out[f"a_{name}_scalar"] = _tensor(dt, (), 100 + i)
    out["empty"] = torch.zeros((0, 5))
    return out


@pytest.mark.parametrize("dtypes", [[d] for d in DTYPES] + [DTYPES],
                         ids=[n for n, _ in DTYPES] + ["all"])
@pytest.mark.parametrize("metadata", [None, {}, {"format": "pt"}],
                         ids=["no-meta", "empty-meta", "one-entry"])
def test_bytes_and_tensors_match_the_package(dtypes, metadata):
    tensors = _tensors(dtypes)
    ours = safetensors_io.save(tensors, metadata)
    assert ours == ref_save(tensors, metadata)
    if metadata is not None:
        assert safetensors_io.metadata(ours) == metadata
    for got in (safetensors_io.load(ours), ref_load(ours)):
        assert got.keys() == tensors.keys()
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert torch.equal(_bits(got[k]), _bits(t)), k


def test_reads_numpy_written_files(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"latents": rng.standard_normal((16, 4, 4)).astype(np.float32),
              "mask": rng.random((8, 8)).astype(np.float16),
              "ids": np.arange(5, dtype=np.int64)}
    (tmp_path / "x.safetensors").write_bytes(np_save(arrays, metadata={"k": "v"}))
    got = safetensors_io.load_file(tmp_path / "x.safetensors")
    assert safetensors_io.metadata((tmp_path / "x.safetensors").read_bytes()) == {"k": "v"}
    for k, a in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), a)
    assert safetensors_io.save(arrays, {"k": "v"}) == np_save(arrays, metadata={"k": "v"})
