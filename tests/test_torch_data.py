"""The port's data pipeline (diffusion_pipe_tpu_torch/data) against the JAX
package's on the same inputs.

- bucketing: every function gives the JAX package's outputs;
- a dataset of PNGs of three aspect ratios, with captions (and a repeated
  directory), scanned, cached through the same stand-in encoders and
  iterated for two epochs by each package: the same bucket groups (keys
  and record order), and the same batches in the same order, bit for bit;
- the cache: a record written by either package reads in the other, item
  for item and bit for bit, metadata included; a pipeline's encoder tag
  (the port's SD3 text functions, which differ from the JAX ones) gives
  its cache a fingerprint of its own, so the JAX package's is rebuilt; the native reader
  (native/cache_reader.cpp, built into build/native/) gives the bytes of
  the Python reader.
"""

import numpy as np
import pytest
import torch

from diffusion_pipe_tpu.data import bucketing as jb
from diffusion_pipe_tpu.data import cache as jcache
from diffusion_pipe_tpu.data.dataset import Dataset as JaxDataset
from diffusion_pipe_tpu.data.loader import DatasetManager as JaxManager
from diffusion_pipe_tpu.data.loader import PipelineDataLoader as JaxLoader
from diffusion_pipe_tpu_torch.data import bucketing as pb
from diffusion_pipe_tpu_torch.data import cache as pcache
from diffusion_pipe_tpu_torch.data.dataset import Dataset as PortDataset
from diffusion_pipe_tpu_torch.data.loader import DatasetManager as PortManager
from diffusion_pipe_tpu_torch.data.loader import PipelineDataLoader as PortLoader
from torch_port_helpers import one_torch_thread  # noqa: F401

BUCKET_CASES = [
    ("seed_from_hash", ((512, 512, 1),)),
    ("seed_from_hash", ("/data/images",)),
    ("build_ar_buckets", (True,)),
    ("build_ar_buckets", (True, [[512, 768], 1.0, 1.5, [768, 512]])),
    ("build_ar_buckets", (False,)),
    ("build_ar_buckets", (True, None, 0.25, 4.0, 7)),
    ("build_frame_buckets", ([33, 17],)),
    ("build_frame_buckets", (None,)),
    ("find_closest_ar_bucket", (np.log(np.geomspace(0.5, 2.0, 9)), 640, 480)),
    ("find_closest_ar_bucket", (np.log(np.geomspace(0.5, 2.0, 9)), 300, 1000)),
    ("find_frame_bucket", (np.array([1, 17, 33]), 20)),
    ("find_frame_bucket", (np.array([17, 33]), 5)),
    ("size_bucket_from_resolution", (1.5, 512, 1, 16)),
    ("size_bucket_from_resolution", (0.5, 1024.0, 33, 32)),
    ("find_closest_size_bucket", (np.array([[768, 512, 33], [512, 512, 1], [512, 768, 1]]),
                                  700, 500, 1)),
    ("find_closest_size_bucket", (np.array([[768, 512, 33]]), 700, 500, 1)),
    ("shuffle_captions", (["a, b, c", "d, e"], 0, ", ", "pre ")),
]


@pytest.mark.parametrize("name,args", BUCKET_CASES, ids=[f"{n}-{i}" for i, (n, _) in
                                                          enumerate(BUCKET_CASES)])
def test_bucketing_matches(name, args):
    ours, ref = getattr(pb, name)(*args), getattr(jb, name)(*args)
    if isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(ours, ref)
    else:
        assert ours == ref
    shuffled = [list(range(20)), list(range(20))]
    pb.shuffle_with_seed(shuffled[0], 7)
    jb.shuffle_with_seed(shuffled[1], 7)
    assert shuffled[0] == shuffled[1]


class _Stub:
    """A pipeline as the data pipeline sees it: stand-in encoders, the same
    function in both packages (latents: 8x8 mean pooling of the pixels)."""

    framerate = None

    def __init__(self, name, as_torch):
        self.name = name
        self.as_torch = as_torch

    def _out(self, arr):
        return torch.from_numpy(arr) if self.as_torch else arr

    def get_call_vae_fn(self):
        def fn(pixels):
            b, c, h, w = pixels.shape
            z = pixels.reshape(b, c, h // 8, 8, w // 8, 8).mean(axis=(3, 5)).astype(np.float32)
            return {"latents": self._out(z)}
        return fn

    def get_call_text_encoder_fns(self):
        def fn(captions):
            return {"t5_embed": self._out(np.stack(
                [np.full((4, 8), len(c), np.float32) + np.arange(8, dtype=np.float32)
                 for c in captions]))}
        return [fn]


@pytest.fixture(scope="module")
def media_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    sizes = [(128, 128), (192, 128), (128, 192), (160, 128), (128, 128), (192, 128), (128, 176)]
    for i, (w, h) in enumerate(sizes):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(root / f"im{i}.png")
        (root / f"im{i}.txt").write_text(f"caption {i}, tag {i % 3}")
    return root


def _dataset_config(root):
    return {"resolutions": [128], "enable_ar_bucket": True, "min_ar": 0.5, "max_ar": 2.0,
            "num_ar_buckets": 5,
            "directory": [{"path": str(root), "num_repeats": 2}]}


def _run(dataset_cls, manager_cls, loader_cls, pipe, root):
    ds = dataset_cls(_dataset_config(root), pipe)
    manager = manager_cls(pipe)
    manager.register(ds)
    manager.cache()
    groups = {sb: [[r.key() for r in b.records] for b in buckets]
              for sb, buckets in ds.buckets_by_size.items()}
    ds.post_init(0, 1, 2, 1)
    loader = loader_cls(ds, 1)
    batches = []
    for _ in range(2 * len(ds)):
        sb, batch = next(loader)
        batches.append((sb, loader.epoch, {k: np.asarray(v) for k, v in batch.items()}))
    return groups, batches, loader.state_dict()


def test_scan_groups_and_epoch_order_match(media_dir):
    g_jax, b_jax, s_jax = _run(JaxDataset, JaxManager, JaxLoader, _Stub("jaxstub", False),
                               media_dir)
    g_port, b_port, s_port = _run(PortDataset, PortManager, PortLoader, _Stub("portstub", True),
                                  media_dir)
    assert len(g_port) >= 2 and g_port == g_jax
    assert s_port == s_jax
    assert len(b_port) == len(b_jax) > 4
    for (sb_p, ep_p, bp), (sb_j, ep_j, bj) in zip(b_port, b_jax):
        assert (sb_p, ep_p) == (sb_j, ep_j) and bp.keys() == bj.keys()
        for k in bj:
            np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)


def _record(rng):
    return {"latents": rng.standard_normal((16, 8, 6)).astype(np.float32),
            "mask": rng.random((64, 48)).astype(np.float16),
            "ids": rng.integers(-5, 5, (7,)).astype(np.int64)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_written_by_one_package_reads_in_the_other(tmp_path, writer):
    rng = np.random.default_rng(1)
    records = [_record(rng) for _ in range(5)]
    meta = {"caption": "a cat"}
    w_mod, r_mod = (jcache, pcache) if writer == "jax" else (pcache, jcache)
    w = w_mod.Cache(tmp_path, "fp")
    for i, rec in enumerate(records):
        w.write(i, rec if writer == "jax" else {k: torch.from_numpy(v) for k, v in rec.items()},
                meta if i == 2 else None)
    w.close()
    r = r_mod.Cache(tmp_path, "fp")
    assert len(r) == 5 and r.num_contiguous() == 5
    for i, rec in enumerate(records):
        got, got_meta = r.read(i, with_metadata=True)
        assert got_meta == (meta if i == 2 else {})
        assert set(got) == set(rec)
        for k, v in rec.items():
            assert np.asarray(got[k]).dtype == v.dtype
            np.testing.assert_array_equal(np.asarray(got[k]), v)
    r.close()


def test_native_reader_equals_python_reader(tmp_path):
    from diffusion_pipe_tpu_torch.data import native_cache

    assert native_cache.available()
    assert native_cache._LIB.parent.name == "native" and native_cache._LIB.parent.parent.name == "build"
    rng = np.random.default_rng(2)
    c = pcache.Cache(tmp_path, "fp", shard_size=4096)  # several shards
    records = [_record(rng) for _ in range(6)]
    for i, rec in enumerate(records):
        c.write(i, rec)
    native = [c.read(i) for i in range(6)]
    assert c.last_reader == "native"
    c._invalidate_reader()
    c._reader_failed = True
    python = [c.read(i) for i in range(6)]
    assert c.last_reader == "python"
    assert len(list(tmp_path.glob("shard_*.bin"))) > 1
    for a, b, rec in zip(native, python, records):
        for k in rec:
            assert torch.equal(a[k], b[k])
            np.testing.assert_array_equal(a[k].numpy(), rec[k])
    c.close()


class _CountingStub(_Stub):
    """The port's stub with the pipeline's cache tags, counting encoder
    calls."""

    def __init__(self, name, text_tag):
        super().__init__(name, True)
        self.text_cache_tag, self.calls = text_tag, {"vae": 0, "text": 0}

    def get_call_vae_fn(self):
        fn = super().get_call_vae_fn()
        return lambda pixels: (self.calls.__setitem__("vae", self.calls["vae"] + 1), fn(pixels))[1]

    def get_call_text_encoder_fns(self):
        (fn,) = super().get_call_text_encoder_fns()
        return [lambda caps: (self.calls.__setitem__("text", self.calls["text"] + 1), fn(caps))[1]]


@pytest.mark.parametrize("family", ["sd3", "flux"])
def test_jax_sd3_text_cache_is_rebuilt(tmp_path, media_dir, family):
    """A cache the JAX package wrote under <dataset>/cache/<family>: the
    port's SD3 pipeline, whose CLIP functions differ from the JAX ones,
    tags its text cache (SD3Pipeline.text_cache_tag) and rebuilds it; its
    latents, and every cache of Flux (no tag), are read as written."""
    import shutil

    from diffusion_pipe_tpu_torch.models.flux import FluxPipeline
    from diffusion_pipe_tpu_torch.models.sd3 import SD3Pipeline

    root = tmp_path / "media"
    shutil.copytree(media_dir, root, ignore=shutil.ignore_patterns("cache"))
    _run(JaxDataset, JaxManager, JaxLoader, _Stub(family, False), root)
    tag = {"sd3": SD3Pipeline, "flux": FluxPipeline}[family].__dict__.get("text_cache_tag")
    assert (tag is not None) == (family == "sd3")
    port = _CountingStub(family, tag)
    _run(PortDataset, PortManager, PortLoader, port, root)
    assert port.calls["vae"] == 0 and (port.calls["text"] > 0) == (family == "sd3")
    again = _CountingStub(family, tag)
    _run(PortDataset, PortManager, PortLoader, again, root)
    assert again.calls == {"vae": 0, "text": 0}
