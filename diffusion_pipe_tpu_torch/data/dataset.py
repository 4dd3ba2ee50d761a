"""Dataset hierarchy: directory scan -> buckets -> batched interleave.

The port's copy of diffusion_pipe_tpu/data/dataset.py, with the same
structure (DirectoryDataset -> SizeBucketDataset ->
ConcatenatedBatchedDataset -> Dataset; the loader is data/loader.py) and
the same results: the same bucket groups, the same seeded shuffles
(seed_from_hash of the bucket key, shuffle_with_seed), so the same batches
in the same order as the JAX package, and the same metadata and cache
files. Caching runs the batched encoders on the card in-process; records
are CPU torch tensors, which the trainer moves to the card.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import IMAGE_EXTENSIONS, VIDEO_EXTENSIONS
from .bucketing import (
    build_ar_buckets,
    build_frame_buckets,
    find_closest_ar_bucket,
    find_closest_size_bucket,
    find_frame_bucket,
    seed_from_hash,
    shuffle_captions,
    shuffle_with_seed,
    size_bucket_from_resolution,
)
from .cache import Cache, map_and_cache
from .preprocess import PreprocessMediaFile

CAPTIONS_JSON_FILE = "captions.json"


def _config_fingerprint(obj) -> str:
    import hashlib

    return hashlib.md5(json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()


class Record:
    """One media file + captions + optional mask/control paths."""

    __slots__ = ("spec", "mask_path", "control_path", "captions", "width",
                 "height", "frames")

    def __init__(self, spec, captions, width, height, frames,
                 mask_path=None, control_path=None):
        self.spec = spec  # (tar_or_None, path)
        self.captions = captions
        self.width = width
        self.height = height
        self.frames = frames
        self.mask_path = mask_path
        self.control_path = control_path

    def key(self):
        return (str(self.spec[0]), str(self.spec[1]))


class DirectoryDataset:
    """Enumerate one directory, probe metadata, assign buckets.

    Directory-level
    settings override dataset-level; captions from sidecar .txt or
    captions.json; AR buckets geomspace or user ars; explicit size_buckets
    mode; frame buckets with forced image bucket.
    """

    def __init__(self, directory_config, dataset_config, model_name,
                 framerate=None, round_to_multiple=32, support_video=False):
        self.directory_config = dict(directory_config)
        self.dataset_config = dataset_config
        self.model_name = model_name
        self.framerate = framerate
        self.round_to_multiple = round_to_multiple
        self.support_video = support_video
        g = self._get

        self.path = Path(self.directory_config["path"])
        if not self.path.is_dir():
            raise RuntimeError(f"Invalid path: {self.path}")
        self.mask_path = Path(g("mask_path")) if g("mask_path") else None
        self.control_path = Path(g("control_path")) if g("control_path") else None
        self.num_repeats = int(g("num_repeats", 1))
        self.enable_ar_bucket = bool(g("enable_ar_bucket", False))
        self.skip_empty_caption = bool(g("skip_empty_caption", True))
        self.cache_shuffle_num = int(g("cache_shuffle_num", 0))
        # shuffle_tags back-compat: implies one caption shuffle
        #
        if bool(g("shuffle_tags", False)) and self.cache_shuffle_num == 0:
            self.cache_shuffle_num = 1
        self.cache_shuffle_delimiter = g("cache_shuffle_delimiter", ", ")
        self.caption_prefix = g("caption_prefix", "")
        # record order within the directory is shuffled by path hash
        #, default on
        self.shuffle_metadata = bool(g("shuffle_metadata", True))
        # fallback mask when a per-image mask is missing
        #
        dmf = self.directory_config.get("default_mask_file")
        self.default_mask_file = Path(dmf) if dmf else None
        if self.default_mask_file is not None and not self.default_mask_file.is_file():
            raise RuntimeError(
                f"Invalid default_mask_file: {self.default_mask_file}"
            )

        size_buckets = g("size_buckets")
        self.use_size_buckets = size_buckets is not None
        if self.use_size_buckets:
            sb = sorted(size_buckets, key=lambda t: t[-1], reverse=True)
            self.size_buckets = np.array(sb)
            self.resolutions = None
        else:
            self.size_buckets = None
            self.resolutions = sorted(
                set(float(r) for r in g("resolutions", [512]))
            )
        self.ars = build_ar_buckets(
            self.enable_ar_bucket,
            ar_buckets=g("ar_buckets"),
            min_ar=float(g("min_ar", 0.5)),
            max_ar=float(g("max_ar", 2.0)),
            num_ar_buckets=int(g("num_ar_buckets", 9)),
        )
        self.log_ars = np.log(self.ars)
        self.frame_buckets = build_frame_buckets(g("frame_buckets", [1]))

        captions_json = self.path / CAPTIONS_JSON_FILE
        self.captions_dict = None
        if captions_json.exists():
            with open(captions_json) as f:
                self.captions_dict = json.load(f)

    def _get(self, key, default=None):
        return self.directory_config.get(key, self.dataset_config.get(key, default))

    # --- enumeration & metadata -------------------------------------------

    def _list_files(self) -> List[Tuple[Optional[str], str]]:
        specs = []
        for p in sorted(self.path.rglob("*")):
            suffix = p.suffix.lower()
            if suffix == ".tar":
                # enumerate media members;
                # captions for tar members come from captions.json keyed by
                # the full member name
                import tarfile

                with tarfile.TarFile(p) as tf:
                    for name in sorted(tf.getnames()):
                        msuf = Path(name).suffix.lower()
                        if msuf in IMAGE_EXTENSIONS or (
                            self.support_video and msuf in VIDEO_EXTENSIONS
                        ):
                            specs.append((str(p), name))
            elif suffix in IMAGE_EXTENSIONS or (
                self.support_video and suffix in VIDEO_EXTENSIONS
            ):
                specs.append((None, str(p)))
        return specs

    def _captions_for(self, filepath: str, in_tar: bool = False
                      ) -> Optional[List[str]]:
        p = Path(filepath)
        if self.captions_dict is not None:
            # tar members are keyed by FULL member name, plain files by
            # basename
            key = filepath if in_tar else p.name
            if key in self.captions_dict:
                caps = self.captions_dict[key]
                return caps if isinstance(caps, list) else [caps]
        if in_tar:
            return None
        txt = p.with_suffix(".txt")
        if txt.exists():
            caption = txt.read_text().strip()
            return [caption]
        return None

    def _probe(self, filepath: str, tar_path: Optional[str] = None):
        if tar_path is not None:
            import tarfile

            if not hasattr(self, "_probe_tars"):
                self._probe_tars = {}
            if tar_path not in self._probe_tars:
                self._probe_tars[tar_path] = tarfile.TarFile(tar_path)
            f = self._probe_tars[tar_path].extractfile(filepath)
            suffix = Path(filepath).suffix.lower()
            if suffix in VIDEO_EXTENSIONS:
                import imageio.v3 as iio

                frames = sum(1 for _ in iio.imiter(f.read()))
                f2 = self._probe_tars[tar_path].extractfile(filepath)
                first = next(iter(iio.imiter(f2.read())))
                h, w = first.shape[:2]
                return w, h, max(frames, 1)
            from PIL import Image

            with Image.open(f) as img:
                return img.width, img.height, 1
        suffix = Path(filepath).suffix.lower()
        if suffix in VIDEO_EXTENSIONS:
            import imageio.v3 as iio

            meta = iio.immeta(filepath)
            fps = meta.get("fps", self.framerate or 24)
            duration = meta.get("duration", 0) or 0
            frames = int(duration * (self.framerate or fps))
            first = next(iter(iio.imiter(filepath)))
            h, w = first.shape[:2]
            if frames <= 1:
                # duration metadata missing (e.g. GIF): count frames
                frames = sum(1 for _ in iio.imiter(filepath))
            return w, h, max(frames, 1)
        from PIL import Image

        with Image.open(filepath) as img:
            return img.width, img.height, 1

    def _sidecar(self, base_dir: Optional[Path], filepath: str):
        if base_dir is None:
            return None
        rel = Path(filepath).relative_to(self.path)
        for cand in (base_dir / rel, *(
            (base_dir / rel).with_suffix(ext) for ext in IMAGE_EXTENSIONS
        )):
            if cand.exists():
                return str(cand)
        return None

    def scan(self) -> Dict[Tuple, List[Record]]:
        """Returns {size_bucket (w,h,f): [records]} after bucket assignment."""
        groups: Dict[Tuple, List[Record]] = defaultdict(list)
        specs = self._list_files()
        if self.shuffle_metadata:
            # per-directory record shuffle seeded by path hash; buckets
            # inherit this order before their
            # own size-bucket-seeded shuffle
            rng = np.random.default_rng(seed_from_hash(str(self.path)))
            specs = [specs[i] for i in rng.permutation(len(specs))]
        for spec in specs:
            filepath = spec[1]
            captions = self._captions_for(filepath, in_tar=spec[0] is not None)
            if captions is None:
                captions = [""]
            if self.skip_empty_caption and all(not c for c in captions):
                continue
            captions = shuffle_captions(
                captions, self.cache_shuffle_num, self.cache_shuffle_delimiter,
                self.caption_prefix,
            )
            try:
                w, h, frames = self._probe(filepath, tar_path=spec[0])
            except Exception as e:
                print(f"skipping unreadable file {filepath}: {e}")
                continue
            in_tar = spec[0] is not None
            mask_path = (None if in_tar
                         else self._sidecar(self.mask_path, filepath))
            if mask_path is None and self.default_mask_file is not None:
                mask_path = str(self.default_mask_file)
            rec = Record(
                spec, captions, w, h, frames,
                mask_path=mask_path,
                control_path=None if in_tar
                else self._sidecar(self.control_path, filepath),
            )
            if self.use_size_buckets:
                sb = find_closest_size_bucket(self.size_buckets, w, h, frames)
                if sb is None:
                    continue
                groups[(sb, max(sb[0], sb[1]))].append(rec)
            else:
                ar_idx = find_closest_ar_bucket(self.log_ars, w, h)
                fb = find_frame_bucket(self.frame_buckets, frames)
                if fb is None:
                    continue
                ar = self.ars[ar_idx]
                for res in self.resolutions:
                    sb = size_bucket_from_resolution(
                        ar, res, fb, self.round_to_multiple
                    )
                    groups[(sb, int(res))].append(rec)
        # keys: (size_bucket, resolution) so per-resolution micro-batch-size
        # maps can apply
        return dict(groups)

    # --- metadata caching ---------------------------------------------------

    def _metadata_fingerprint(self, specs) -> str:
        """Cheap fingerprint: config + file list + caption-sidecar mtimes
        (no media probing). Invalidates on added/removed files, changed
        captions, or changed bucket settings."""
        sidecars = []
        cj = self.path / CAPTIONS_JSON_FILE
        if cj.exists():
            sidecars.append((str(cj), cj.stat().st_mtime_ns))
        for tar, fp in specs:
            if tar is None:
                txt = Path(fp).with_suffix(".txt")
                if txt.exists():
                    sidecars.append((str(txt), txt.stat().st_mtime_ns))
        return _config_fingerprint(
            [self.directory_config, self.model_name, self.round_to_multiple,
             self.support_video, self.framerate, specs, sidecars]
        )

    def scan_cached(self, cache_root, regenerate=False, trust_cache=False):
        """scan() with a JSON metadata cache (and --trust_cache): by default the
        cache is validated against a cheap fingerprint (file list + caption
        mtimes — media probing skipped on hit); with trust_cache even the
        file listing is skipped and the cache loaded blindly."""
        meta_file = Path(cache_root) / "metadata.json"
        if not regenerate and meta_file.exists():
            data = json.loads(meta_file.read_text())
            if trust_cache:
                return self._groups_from_json(data["groups"])
            specs = self._list_files()
            if data.get("fingerprint") == self._metadata_fingerprint(specs):
                return self._groups_from_json(data["groups"])
        groups = self.scan()
        specs = self._list_files()
        meta_file.parent.mkdir(parents=True, exist_ok=True)
        meta_file.write_text(json.dumps({
            "fingerprint": self._metadata_fingerprint(specs),
            "groups": self._groups_to_json(groups),
        }))
        return groups

    @staticmethod
    def _groups_to_json(groups):
        out = []
        for (sb, res), records in groups.items():
            out.append({
                "size_bucket": list(sb), "resolution": int(res),
                "records": [
                    {
                        "spec": list(r.spec), "captions": r.captions,
                        "width": r.width, "height": r.height,
                        "frames": r.frames, "mask_path": r.mask_path,
                        "control_path": r.control_path,
                    }
                    for r in records
                ],
            })
        return out

    @staticmethod
    def _groups_from_json(data):
        groups = {}
        for entry in data:
            key = (tuple(entry["size_bucket"]), int(entry["resolution"]))
            groups[key] = [
                Record(
                    tuple(r["spec"]), r["captions"], r["width"], r["height"],
                    r["frames"], mask_path=r["mask_path"],
                    control_path=r["control_path"],
                )
                for r in entry["records"]
            ]
        return groups


class SizeBucketDataset:
    """All records of one (w, h, frames) bucket in one directory, with
    latent + text-embedding caches."""

    def __init__(self, records: List[Record], directory: DirectoryDataset,
                 size_bucket: Tuple[int, int, int], cache_root: Path,
                 include_captions: bool = False, resolution: int = 0,
                 cache_tags: Tuple[Optional[str], Optional[str]] = (None, None)):
        self.include_captions = include_captions
        # (latent, text) encoder tags of the pipeline: a cache written by
        # other encoders under the same folder (the JAX package's) gets
        # another fingerprint and is rebuilt; None keeps the shared one
        self.latent_tag, self.text_tag = cache_tags
        self.resolution = resolution  # originating training resolution
        self.size_bucket = tuple(int(x) for x in size_bucket)
        self.directory = directory
        records = list(records)
        # deterministic per-bucket shuffle
        shuffle_with_seed(records, seed_from_hash(self.size_bucket))
        self.records = records
        suffix = "x".join(str(x) for x in self.size_bucket)
        self.cache_dir = Path(cache_root) / f"cache_{suffix}"
        self.latent_cache: Optional[Cache] = None
        self.te_caches: List[Cache] = []
        self.uncond_embeddings: Optional[dict] = None
        # iteration order: (record_idx, caption_number) pairs, grouped by
        # caption number for mostly-sequential reads (dataset.py:247-298)
        n_caps = [len(r.captions) for r in records]
        max_caps = max(n_caps) if n_caps else 0
        self.iteration_order: List[Tuple[int, int]] = []
        for cap_i in range(max_caps):
            for rec_i, n in enumerate(n_caps):
                if cap_i < n:
                    self.iteration_order.append((rec_i, cap_i))

    def __len__(self):
        return len(self.iteration_order) * self.directory.num_repeats

    def fingerprint(self) -> str:
        parts = [self.size_bucket, [r.key() for r in self.records], self.directory.num_repeats]
        controls = [r.control_path for r in self.records]
        if any(c is not None for c in controls):
            # the control images' latents are cached with the targets': a
            # control_path added or changed rebuilds the cache (the JAX
            # package's fingerprint leaves it out)
            parts.append([str(c) for c in controls])
        return _config_fingerprint(parts)

    def _tagged(self, parts: list, tag: Optional[str]) -> str:
        return _config_fingerprint(parts if tag is None else parts + [tag])

    def cache_latents(self, vae_fn, regenerate=False, caching_batch_size=1):
        preprocessor = PreprocessMediaFile(
            self.directory.dataset_config,
            support_video=self.directory.support_video,
            framerate=self.directory.framerate,
        )
        w, h, f = self.size_bucket

        def map_fn(recs: List[Record]):
            pixels, masks, controls = [], [], []
            for rec in recs:
                items = preprocessor(rec.spec, rec.mask_path, (w, h, f))
                px, mask = items[0]
                pixels.append(px)
                masks.append(mask)
                if rec.control_path is not None:
                    c_items = preprocessor((None, rec.control_path), None, (w, h, f))
                    controls.append(c_items[0][0])
                else:
                    controls.append(None)
            batch = np.stack(pixels)
            out = vae_fn(batch)  # dict of CPU tensors, batch-leading
            results = []
            for i in range(len(recs)):
                tensors = {k: v[i] for k, v in out.items()}
                if masks[i] is not None:
                    tensors["mask"] = torch.from_numpy(masks[i])
                if controls[i] is not None:
                    c_out = vae_fn(np.stack([controls[i]]))
                    tensors["control_latents"] = list(c_out.values())[0][0]
                results.append((tensors, None))
            return results

        self.latent_cache = map_and_cache(
            self.records, map_fn, self.cache_dir / "latents",
            self.fingerprint() if self.latent_tag is None
            else self._tagged([self.fingerprint()], self.latent_tag),
            batch_size=caching_batch_size,
            regenerate=regenerate,
        )

    def cache_text_embeddings(self, te_fn, te_idx: int, regenerate=False,
                              caching_batch_size=1):
        rows = [
            self.records[ri].captions[ci] for ri, ci in self.iteration_order
        ]
        control_files = [
            self.records[ri].control_path for ri, _ in self.iteration_order
        ]
        # TE fns that condition on the control image (qwen_image_edit VLM)
        # declare it by accepting a second positional arg. The
        # control path rides in the row so cache resume stays aligned.
        import inspect

        wants_control = len(
            inspect.signature(te_fn).parameters
        ) >= 2 and any(c is not None for c in control_files)
        if wants_control:
            rows = list(zip(rows, control_files))

            def map_fn(batch):
                caps = [r[0] for r in batch]
                ctrl = [r[1] for r in batch]
                out = te_fn(caps, ctrl)
                return [
                    ({k: v[i] for k, v in out.items()}, None)
                    for i in range(len(caps))
                ]
        else:
            def map_fn(captions: List[str]):
                out = te_fn(captions)
                return [
                    ({k: v[i] for k, v in out.items()}, None)
                    for i in range(len(captions))
                ]

        cache = map_and_cache(
            rows, map_fn, self.cache_dir / f"text_embeddings_{te_idx}",
            self._tagged([self.fingerprint(), rows, te_idx], self.text_tag),
            batch_size=caching_batch_size, regenerate=regenerate,
        )
        if len(self.te_caches) <= te_idx:
            self.te_caches.extend([None] * (te_idx + 1 - len(self.te_caches)))
        self.te_caches[te_idx] = cache

    def set_uncond_embeddings(self, embeddings: Optional[dict]):
        self.uncond_embeddings = embeddings

    def __getitem__(self, i: int) -> Dict[str, torch.Tensor]:
        order_idx = i % len(self.iteration_order)
        rec_i, cap_i = self.iteration_order[order_idx]
        item = dict(self.latent_cache.read(rec_i))
        for cache in self.te_caches:
            if cache is not None:
                item.update(cache.read(order_idx))
        if self.include_captions:
            item["caption"] = np.str_(self.records[rec_i].captions[cap_i])
        return item

    def prefetch(self, indices):
        """Page-warm upcoming records (native reader; no-op otherwise)."""
        n = len(self.iteration_order)
        order = [self.iteration_order[i % n] for i in indices]
        self.latent_cache.prefetch([rec_i for rec_i, _ in order])
        for cache in self.te_caches:
            if cache is not None:
                cache.prefetch([i % n for i in indices])


class ConcatenatedBatchedDataset:
    """Same size bucket across directories, sliced into global batches
   ."""

    def __init__(self, buckets: List[SizeBucketDataset]):
        assert buckets
        self.size_bucket = buckets[0].size_bucket
        self.buckets = buckets
        self.post_initialized = False

    def post_init(self, data_parallel_rank: int, data_parallel_world: int,
                  micro_batch_size: int, gradient_accumulation_steps: int):
        self.dp_rank = data_parallel_rank
        self.dp_world = data_parallel_world
        self.mbs = micro_batch_size
        self.gas = gradient_accumulation_steps
        global_batch = micro_batch_size * data_parallel_world * gradient_accumulation_steps
        total = sum(len(b) for b in self.buckets)
        # global index -> (bucket, local index)
        self.index: List[Tuple[int, int]] = []
        for bi, b in enumerate(self.buckets):
            self.index.extend((bi, i) for i in range(len(b)))
        self.num_global_batches = total // global_batch  # drop remainder
        self.global_batch = global_batch
        self.post_initialized = True

    def __len__(self):
        assert self.post_initialized
        return self.num_global_batches

    def get_batch(self, batch_idx: int, full_global: bool = False
                  ) -> List[Dict[str, torch.Tensor]]:
        """This DP rank's examples for one step: gas*mbs examples — or, with
        full_global (single-controller JAX driving every chip), ALL ranks'
        examples laid out microbatch-major [(m=0, r=0..dp), (m=1, ...)...]
        so the train step's leading-axis split into gas chunks of mbs*dp
        gives data-parallel rank r its m-th microbatch. Warms the NEXT batch's cache pages through the
        native reader's prefetch threads (Cache.prefetch; no-op without the
        C++ lib) so large video latents stream from the page cache while
        the step runs."""
        assert self.post_initialized
        per_rank = self.mbs * self.gas

        def rank_slice(bidx):
            start = bidx * self.global_batch
            if not full_global:
                return self.index[
                    start + self.dp_rank * per_rank
                    : start + (self.dp_rank + 1) * per_rank
                ]
            rows = []
            for m in range(self.gas):
                for r in range(self.dp_world):
                    base = start + r * per_rank + m * self.mbs
                    rows.extend(self.index[base : base + self.mbs])
            return rows

        if batch_idx + 1 < self.num_global_batches:
            pending = {}
            for bi, i in rank_slice(batch_idx + 1):
                pending.setdefault(bi, []).append(i)
            for bi, idxs in pending.items():
                self.buckets[bi].prefetch(idxs)
        return [self.buckets[bi][i] for bi, i in rank_slice(batch_idx)]


def collate(examples: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack matching keys (captions, which are strings, into a list); an
    optional key (mask, control) missing in any example drops the key."""
    keys = set(examples[0])
    for e in examples[1:]:
        keys &= set(e)
    return {k: torch.stack([e[k] for e in examples]) if torch.is_tensor(examples[0][k])
            else [e[k] for e in examples] for k in sorted(keys)}


class Dataset:
    """Outermost dataset: all directories, bucket interleave, collation
   ."""

    def __init__(self, dataset_config: dict, model_pipeline,
                 support_video: bool = False, round_to_multiple: int = 32):
        self.dataset_config = dataset_config
        self.pipeline = model_pipeline
        self.support_video = support_video
        self.directories = [
            DirectoryDataset(
                dc, dataset_config, model_pipeline.name,
                framerate=model_pipeline.framerate,
                round_to_multiple=round_to_multiple,
                support_video=support_video,
            )
            for dc in dataset_config["directory"]
        ]
        self.buckets_by_size: Dict[Tuple, List[SizeBucketDataset]] = {}
        self.concat_datasets: List[ConcatenatedBatchedDataset] = []
        self.uncond_fraction = float(dataset_config.get("uncond_fraction", 0.0))
        self.post_initialized = False

    def scan(self, cache_root_name: str = "cache", regenerate: bool = False,
             trust_cache: bool = False):
        self.buckets_by_size = defaultdict(list)
        for d in self.directories:
            cache_root = d.path / cache_root_name / self.pipeline.name
            groups = d.scan_cached(
                cache_root, regenerate=regenerate, trust_cache=trust_cache
            )
            include_captions = getattr(
                self.pipeline, "pass_captions_to_batch", False
            )
            cache_tags = (getattr(self.pipeline, "latent_cache_tag", None),
                          getattr(self.pipeline, "text_cache_tag", None))
            for (sb, res), records in sorted(groups.items()):
                self.buckets_by_size[sb].append(
                    SizeBucketDataset(records, d, sb, cache_root,
                                      include_captions=include_captions,
                                      resolution=res, cache_tags=cache_tags)
                )
        return self.buckets_by_size

    def all_size_bucket_datasets(self):
        return [b for buckets in self.buckets_by_size.values() for b in buckets]

    def post_init(self, data_parallel_rank: int, data_parallel_world: int,
                  micro_batch_size, gradient_accumulation_steps: int,
                  image_micro_batch_size=None, full_global: bool = False):
        """micro_batch_size: int or per-resolution map {res_or_None: bs}
       ; image_micro_batch_size applies to
        frames==1 buckets when given. full_global: yield every DP rank's
        examples per batch, microbatch-major (single-controller training)."""
        self.full_global = full_global
        from ..config import lookup_batch_size

        def resolve(bs_map, bucket):
            if isinstance(bs_map, int):
                return bs_map
            res = bucket.buckets[0].resolution or None
            return lookup_batch_size(bs_map, res)

        self.concat_datasets = []
        for sb in sorted(self.buckets_by_size):
            cd = ConcatenatedBatchedDataset(self.buckets_by_size[sb])
            bs_map = micro_batch_size
            if image_micro_batch_size is not None and sb[2] == 1:
                bs_map = image_micro_batch_size
            cd.post_init(
                data_parallel_rank, data_parallel_world, resolve(bs_map, cd),
                gradient_accumulation_steps,
            )
            if len(cd) > 0:
                self.concat_datasets.append(cd)
        if not self.concat_datasets:
            raise RuntimeError(
                "Dataset is empty after batching; add data or reduce batch size"
            )
        # fixed bucket interleave, shuffled ONCE with seed 0 and identical
        # every epoch; subsample_ratio keeps
        # only the leading fraction (dataset.py:983-985)
        order = [
            ci
            for ci, cd in enumerate(self.concat_datasets)
            for _ in range(len(cd))
        ]
        shuffle_with_seed(order, 0)
        cum = [0] * len(self.concat_datasets)
        self.iteration_order = []
        for ci in order:
            self.iteration_order.append((ci, cum[ci]))
            cum[ci] += 1
        if ratio := self.dataset_config.get("subsample_ratio"):
            self.iteration_order = self.iteration_order[
                : int(len(self.iteration_order) * float(ratio))
            ]
        self.post_initialized = True

    def batches_per_epoch(self) -> int:
        return len(self.iteration_order)

    def __len__(self) -> int:
        return len(self.iteration_order)

    def iter_epoch(self, epoch: int):
        """Yield (size_bucket, collated batch) in the fixed interleave order
        (identical each epoch)."""
        assert self.post_initialized
        for ci, bi in self.iteration_order:
            cd = self.concat_datasets[ci]
            examples = cd.get_batch(
                bi, full_global=getattr(self, "full_global", False)
            )
            yield cd.size_bucket, collate(examples)
