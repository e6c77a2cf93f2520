"""Dataset readers: reference layout, TUM RGB-D layout, synthetic worlds.

Parity with ``Dataset`` (/root/reference/src/dataset.cc): the reference
layout is ``dataroot/image_names.txt`` (one image filename per line) +
``dataroot/<image_dir>/`` + optional ``dataroot/times.txt``
(/root/reference/README.md:142-153).  Missing timestamps are −1.0 like
``Dataset::GetTimestamp`` (dataset.cc:47-53).

Additionally supports the TUM RGB-D layout (``rgb.txt`` with
``timestamp filename`` lines) used by the BASELINE configs, and an in-memory
synthetic dataset for hermetic tests/benchmarks.

Images are served as float32 grayscale in [0, 1] (the engine's input
contract; the reference reads uint8 grayscale and normalizes by 255 in
``ConvertMatToNormalizedArray``, /root/reference/src/utils.cc:110-118).

For high-throughput benchmarking, ``pack()`` converts any dataset into the
packed binary format served by the native C++ prefetching loader
(``nislam_tpu.io.native_loader``).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _imread_gray_u8(path: str) -> np.ndarray:
    """Grayscale uint8 image via cv2 or PIL."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    except ImportError:
        pass
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("L"), np.uint8)
    except ImportError as exc:
        raise RuntimeError(
            f"no image backend (cv2/PIL) available to read {path}"
        ) from exc


def _normalized(img: np.ndarray, t: float) -> Tuple[np.ndarray, float]:
    """uint8 frames → float32 [0, 1]; float frames pass through."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img, t


def _imread_gray(path: str) -> np.ndarray:
    """Grayscale float32 [0,1] image."""
    return _imread_gray_u8(path).astype(np.float32) / 255.0


class _Base:
    def __len__(self) -> int:
        raise NotImplementedError

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        """Returns (image f32 [0,1] of shape (H, W), timestamp or −1.0)."""
        raise NotImplementedError

    def get_raw(self, idx: int) -> Tuple[np.ndarray, float]:
        """Like :meth:`get` but in the source's native dtype: uint8 for
        8-bit image files (the engine normalizes /255 on device — 4× fewer
        host→device bytes, bit-identical results), f32 for float sources.
        Default: the f32 path."""
        return self.get(idx)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, float]]:
        for i in range(len(self)):
            yield self.get(i)

    def chunks(
        self, size: int, raw: bool = False
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images (N≤size, H, W), times (N,)) stacked chunks — the
        unit the ``lax.scan`` driver consumes.  ``raw=True`` serves the
        source dtype (see :meth:`get_raw`)."""
        getter = self.get_raw if raw else self.get
        n = len(self)
        for start in range(0, n, size):
            idx = range(start, min(start + size, n))
            pairs = [getter(i) for i in idx]
            yield (
                np.stack([p[0] for p in pairs]),
                np.asarray([p[1] for p in pairs], np.float64),
            )

    def pack(self, out_path: str) -> str:
        """Write the packed binary format of the native loader
        (see nislam_tpu/native/loader.cc): little-endian header
        ``magic 'NISF' | u32 version | u32 n | u32 h | u32 w`` followed by
        n float64 timestamps and n raw (H, W) frames — version 2 / uint8
        when the source is 8-bit (4× smaller file AND 4× fewer
        host→device bytes at read time; the engine normalizes on device),
        version 1 / f32 for float sources (synthetic worlds)."""
        import struct

        img0, _ = self.get_raw(0)
        u8 = img0.dtype == np.uint8
        h, w = img0.shape
        n = len(self)
        with open(out_path, "wb") as f:
            f.write(struct.pack("<4sIIII", b"NISF", 2 if u8 else 1, n, h, w))
            times = np.asarray([self.get_raw(i)[1] for i in range(n)], "<f8")
            f.write(times.tobytes())
            for i in range(n):
                img, _ = self.get_raw(i)
                if img.shape != (h, w):
                    raise ValueError(f"frame {i} shape {img.shape} != {(h, w)}")
                f.write(
                    img.tobytes() if u8 else img.astype("<f4").tobytes()
                )
        return out_path


class ImageFolderDataset(_Base):
    """The reference's layout (dataset.cc:8-46)."""

    def __init__(self, dataroot: str, image_dir_name: str = "rgb"):
        if not os.path.isdir(dataroot):
            raise FileNotFoundError(f"dataroot {dataroot} doesn't exist")
        self.image_dir = os.path.join(dataroot, image_dir_name)
        names_file = os.path.join(dataroot, "image_names.txt")
        with open(names_file) as f:
            self.names: List[str] = [
                ln.split(",")[0].strip() for ln in f if ln.strip()
            ]
        self.times: List[float] = []
        times_file = os.path.join(dataroot, "times.txt")
        if os.path.exists(times_file):
            with open(times_file) as f:
                self.times = [
                    float(ln.split(",")[0]) for ln in f if ln.strip()
                ]

    def __len__(self) -> int:
        return len(self.names)

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        img = _imread_gray(os.path.join(self.image_dir, self.names[idx]))
        t = self.times[idx] if idx < len(self.times) else -1.0
        return img, t

    def get_raw(self, idx: int) -> Tuple[np.ndarray, float]:
        img = _imread_gray_u8(os.path.join(self.image_dir, self.names[idx]))
        t = self.times[idx] if idx < len(self.times) else -1.0
        return img, t


class TumRgbdDataset(_Base):
    """TUM RGB-D benchmark layout: ``rgb.txt`` lines ``timestamp path``."""

    def __init__(self, dataroot: str, index_file: str = "rgb.txt"):
        self.root = dataroot
        self.entries: List[Tuple[float, str]] = []
        with open(os.path.join(dataroot, index_file)) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                t, rel = ln.split()[:2]
                self.entries.append((float(t), rel))

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        t, rel = self.entries[idx]
        return _imread_gray(os.path.join(self.root, rel)), t

    def get_raw(self, idx: int) -> Tuple[np.ndarray, float]:
        t, rel = self.entries[idx]
        return _imread_gray_u8(os.path.join(self.root, rel)), t


class SyntheticDataset(_Base):
    """In-memory frames (tests/benchmarks); timestamps at a fixed rate.

    uint8 frames are kept as 8-bit camera data (:meth:`get` normalizes,
    :meth:`get_raw` and :meth:`pack` keep uint8); any other dtype is
    taken as float32 in [0, 1]."""

    def __init__(self, frames: np.ndarray, rate_hz: float = 30.0, t0: float = 0.0):
        frames = np.asarray(frames)
        self.frames = frames if frames.dtype == np.uint8 else frames.astype(np.float32)
        self.rate = rate_hz
        self.t0 = t0

    def __len__(self) -> int:
        return len(self.frames)

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        return _normalized(*self.get_raw(idx))

    def get_raw(self, idx: int) -> Tuple[np.ndarray, float]:
        return self.frames[idx], self.t0 + idx / self.rate


class NisfDataset(_Base):
    """A packed NISF file (:meth:`_Base.pack`) read through ``numpy.memmap``
    — the reader where the native loader cannot be built."""

    def __init__(self, path: str):
        import struct

        with open(path, "rb") as f:
            magic, version, n, h, w = struct.unpack("<4sIIII", f.read(20))
        if magic != b"NISF" or version not in (1, 2):
            raise ValueError(f"{path}: not a NISF v1/v2 file")
        self.times = np.memmap(path, "<f8", "r", offset=20, shape=(n,))
        self.frames = np.memmap(
            path, np.uint8 if version == 2 else "<f4", "r",
            offset=20 + 8 * n, shape=(n, h, w),
        )

    def __len__(self) -> int:
        return len(self.times)

    def get(self, idx: int) -> Tuple[np.ndarray, float]:
        return _normalized(*self.get_raw(idx))

    def get_raw(self, idx: int) -> Tuple[np.ndarray, float]:
        return np.asarray(self.frames[idx]), float(self.times[idx])


def open_dataset(dataroot: str, image_dir_name: str = "rgb") -> _Base:
    """Auto-detect the layout: reference (image_names.txt) or TUM (rgb.txt)."""
    if os.path.exists(os.path.join(dataroot, "image_names.txt")):
        return ImageFolderDataset(dataroot, image_dir_name)
    if os.path.exists(os.path.join(dataroot, "rgb.txt")):
        return TumRgbdDataset(dataroot)
    raise FileNotFoundError(
        f"{dataroot}: neither image_names.txt (reference layout) nor "
        "rgb.txt (TUM layout) found"
    )
