"""The port's weight-file helpers (models/weights.py) against the JAX
package's: ComfyUI fp8 dequantization (e4m3 and e5m2 weights with
per-tensor scales, a scale-less fp8 tensor, the marker and input scales
dropped) bit for bit, torch pickles through load_state_dict_any (a
"state_dict" wrapper unwrapped; bf16 kept), and safetensors folders read
through the port's own reader equal to the `safetensors` package's."""

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from diffusion_pipe_tpu.models import weights as jw
from diffusion_pipe_tpu_torch.models import weights as pw


def _fp8_checkpoint():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    return {
        "scaled_fp8": np.zeros((0,), ml_dtypes.float8_e4m3fn),
        "a.weight": w.astype(ml_dtypes.float8_e4m3fn),
        "a.scale_weight": np.asarray(0.37, np.float32),
        "a.scale_input": np.asarray(1.5, np.float32),
        "b.weight": w[:, :2].astype(ml_dtypes.float8_e5m2),
        "b.scale_weight": np.asarray([2.0], np.float32),
        "c.weight": w[:3].astype(ml_dtypes.float8_e4m3fn),
        "a.bias": rng.standard_normal(6).astype(np.float32),
    }


def _torch(v):
    if v.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        dt = torch.float8_e4m3fn if v.dtype.name == "float8_e4m3fn" else torch.float8_e5m2
        return torch.from_numpy(np.ascontiguousarray(v).view(np.uint8).copy()).view(dt)
    return torch.from_numpy(np.array(v))


def test_dequantize_comfy_fp8_matches_jax():
    sd = _fp8_checkpoint()
    ref = jw.dequantize_comfy_fp8(sd)
    ours = pw.dequantize_comfy_fp8({k: _torch(v) for k, v in sd.items()})
    assert ours.keys() == ref.keys() == {"a.weight", "b.weight", "c.weight", "a.bias"}
    for k, v in ref.items():
        assert str(ours[k].dtype).endswith(str(v.dtype)), k
        np.testing.assert_array_equal(ours[k].float().numpy(), v.astype(np.float32), err_msg=k)
    plain = {"x": torch.ones(2)}
    assert pw.dequantize_comfy_fp8(plain) is plain


def test_load_state_dict_any(tmp_path):
    sd = {"w": torch.randn(3, 2).to(torch.bfloat16), "b": torch.arange(4)}
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "m.ckpt")
    got = pw.load_state_dict_any(tmp_path / "m.ckpt")
    assert got.keys() == sd.keys() and all(torch.equal(got[k], v) for k, v in sd.items())
    folder = tmp_path / "st"
    folder.mkdir()
    arrays = {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "y": np.ones(2, np.int64)}
    np_save_file(arrays, str(folder / "one.safetensors"))
    np_save_file({"z": np.zeros(1, np.float16)}, str(folder / "two.safetensors"))
    ours, ref = pw.load_state_dict_any(folder), jw.load_state_dict_any(str(folder))
    assert ours.keys() == ref.keys() == {"x", "y", "z"}
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    with pytest.raises(FileNotFoundError):
        pw.load_safetensors_dir(tmp_path / "empty_dir_that_does_not_exist")
