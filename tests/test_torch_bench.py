"""The port's bench (python -m diffusion_pipe_tpu_torch.bench) runs bench.py's
two rows with bench.py's configurations: the config dicts, batch shapes and
step counts, read from bench.py's source (it imports JAX to run; it is not
run here), equal the port's constants. The bench needs CUDA: without it
main() exits 2 and prints no record.
"""

import ast
from pathlib import Path

import pytest
import torch

from diffusion_pipe_tpu_torch import bench

SOURCE = ast.parse((Path(__file__).resolve().parents[1] / "bench.py").read_text())


def _function(name):
    return next(n for n in SOURCE.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _assigned(fn, name):
    """The literal value of the first `name = ...` (or `name = other = ...`)
    in fn."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def _batch_shapes(fn):
    """{batch key: the shape tuple of its jax.random.normal / jnp.full draw}."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "batch" for t in node.targets):
            out = {}
            for key, call in zip(node.value.keys, node.value.values):
                shape = next(a for a in call.args if isinstance(a, ast.Tuple))
                out[key.value] = shape
            return out
    raise KeyError("batch")


@pytest.mark.parametrize("row", ["flux", "wan"])
def test_configs_equal_bench_py(row):
    fn = _function("main" if row == "flux" else "bench_wan_1_3b")
    ours = bench.FLUX_CONFIG if row == "flux" else bench.WAN_CONFIG
    assert _assigned(fn, "config") == ours


def test_flux_batch_and_steps_equal_bench_py():
    fn = _function("main")
    b = bench.FLUX_BATCH
    assert _assigned(fn, "batch_size") == b["batch_size"]
    assert _assigned(fn, "h") == _assigned(fn, "w") == b["latent_hw"]
    assert _assigned(fn, "txt_len") == b["txt_len"]
    assert _assigned(fn, "n_steps") == b["timed_steps"]


def test_wan_batch_and_steps_equal_bench_py():
    fn = _function("bench_wan_1_3b")
    b = bench.WAN_BATCH
    shapes = {k: ast.literal_eval(v) for k, v in _batch_shapes(fn).items()}
    assert shapes["latents"] == (b["batch_size"], 16, *b["latent_fhw"])
    assert shapes["text_embeddings"] == (b["batch_size"], b["txt_len"], 4096)
    assert shapes["seq_lens"] == (b["batch_size"],)
    assert _assigned(fn, "n_steps") == b["timed_steps"]


def test_main_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 2
    assert capsys.readouterr().out == ""
