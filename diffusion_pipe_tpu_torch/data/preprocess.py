"""Host-side media preprocessing: load, crop/resize, normalize, clip videos.

The port's copy of diffusion_pipe_tpu/data/preprocess.py, the same math:
RGBA composited onto white, ImageOps.fit center crop and resize to the
bucket size rounded to the model multiples (height and width to the
nearest, frames down to 4k+1), pixels normalized to [-1, 1], output
(C, F, H, W), masks from the first channel as float16 at the resized
resolution. Pillow and imageio are imported by the functions that decode
media, so the module imports without them.
"""

from __future__ import annotations

import tarfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..common import (
    VIDEO_EXTENSIONS,
    round_down_to_multiple,
    round_to_nearest_multiple,
)


def extract_clips(video: np.ndarray, target_frames: int, video_clip_mode: str):
    """video: (C, F, H, W)."""
    frames = video.shape[1]
    if frames < target_frames:
        print(
            f"video with shape {video.shape} is being skipped because it has "
            f"less ({frames}) than the target_frames {target_frames}"
        )
        return []
    if video_clip_mode == "single_beginning":
        return [video[:, :target_frames]]
    if video_clip_mode == "single_middle":
        start = int((frames - target_frames) / 2)
        return [video[:, start : start + target_frames]]
    raise NotImplementedError(f"video_clip_mode={video_clip_mode} is not recognized")


def convert_crop_and_resize(pil_img, width_and_height):
    """White-composite, then ImageOps.fit."""
    from PIL import Image, ImageOps

    if pil_img.mode not in ["RGB", "RGBA"] and "transparency" in pil_img.info:
        pil_img = pil_img.convert("RGBA")
    if pil_img.mode == "RGBA":
        canvas = Image.new("RGBA", pil_img.size, (255, 255, 255))
        canvas.alpha_composite(pil_img)
        pil_img = canvas.convert("RGB")
    else:
        pil_img = pil_img.convert("RGB")
    return ImageOps.fit(pil_img, width_and_height)


def _to_tensor_normalized(pil_img) -> np.ndarray:
    """(C, H, W) float32 in [-1, 1] (torchvision ToTensor + Normalize(.5,.5))."""
    arr = np.asarray(pil_img, dtype=np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return np.transpose(arr, (2, 0, 1))


class PreprocessMediaFile:
    """Callable: (spec, mask_filepath, size_bucket) -> [(array CFHW, mask)].

    spec = (tar_path_or_None, file_path): a file, or a member of a tar.
    """

    def __init__(
        self,
        config: Optional[dict] = None,
        support_video: bool = False,
        framerate: Optional[float] = None,
        round_height: int = 16,
        round_width: int = 16,
        round_frames: int = 4,
    ):
        config = config or {}
        self.config = config
        self.video_clip_mode = config.get("video_clip_mode", "single_beginning")
        self.support_video = support_video
        self.framerate = framerate
        self.round_height = round_height
        self.round_width = round_width
        self.round_frames = round_frames
        if self.support_video:
            assert self.framerate, "video preprocessing requires a framerate"
        self.tarfile_map = {}

    def __del__(self):
        for tar_f in self.tarfile_map.values():
            try:
                tar_f.close()
            except Exception:
                pass

    def __call__(self, spec, mask_filepath=None, size_bucket=None):
        from PIL import Image, ImageOps

        is_video = Path(spec[1]).suffix.lower() in VIDEO_EXTENSIONS
        if is_video:
            import imageio.v3 as iio

        if spec[0] is None:
            filepath_or_file = str(spec[1])
        else:
            tar_filename = spec[0]
            if tar_filename not in self.tarfile_map:
                self.tarfile_map[tar_filename] = tarfile.TarFile(tar_filename)
            filepath_or_file = self.tarfile_map[tar_filename].extractfile(
                str(spec[1])
            )

        if is_video:
            assert self.support_video

            def _iter_frames():
                # fps resampling needs the ffmpeg plugin; fall back to native
                # frame rate when unavailable (e.g. GIF via pillow)
                try:
                    yield from iio.imiter(filepath_or_file, fps=self.framerate)
                except (TypeError, OSError, ValueError):
                    yield from iio.imiter(filepath_or_file)

            num_frames = sum(1 for _ in _iter_frames())
            frames_iter = _iter_frames()
        else:
            num_frames = 1
            pil_img = Image.open(filepath_or_file)
            frames_iter = [pil_img]

        if size_bucket is not None:
            bw, bh, bf = size_bucket
        else:
            if is_video:
                first = next(iter(iio.imiter(filepath_or_file, fps=self.framerate)))
                bh, bw = first.shape[:2]
            else:
                bw, bh = pil_img.width, pil_img.height
            bf = num_frames

        height_rounded = round_to_nearest_multiple(bh, self.round_height)
        width_rounded = round_to_nearest_multiple(bw, self.round_width)
        frames_rounded = round_down_to_multiple(bf - 1, self.round_frames) + 1
        resize_wh = (width_rounded, height_rounded)

        mask = None
        if mask_filepath:
            mask_img = Image.open(mask_filepath).convert("RGB")
            if not is_video:
                img_hw = (pil_img.height, pil_img.width)
                mask_hw = (mask_img.height, mask_img.width)
                if mask_hw != img_hw:
                    raise ValueError(
                        f"Mask shape {mask_hw} was not the same as image shape "
                        f"{img_hw}.\nImage path: {spec[1]}\nMask path: {mask_filepath}"
                    )
            mask_img = ImageOps.fit(mask_img, resize_wh)
            mask = (
                np.asarray(mask_img, dtype=np.float32)[..., 0] / 255.0
            ).astype(np.float16)

        frames_out = []
        for frame in frames_iter:
            if not isinstance(frame, Image.Image):
                frame = Image.fromarray(frame)
            cropped = convert_crop_and_resize(frame, resize_wh)
            frames_out.append(_to_tensor_normalized(cropped))
        resized_video = np.stack(frames_out)  # (F, C, H, W)

        if hasattr(filepath_or_file, "close"):
            filepath_or_file.close()

        if not self.support_video:
            return [(resized_video[0], mask)]

        resized_video = np.transpose(resized_video, (1, 0, 2, 3))  # C F H W
        if not is_video:
            return [(resized_video, mask)]
        clips = extract_clips(resized_video, frames_rounded, self.video_clip_mode)
        return [(clip, mask) for clip in clips]
