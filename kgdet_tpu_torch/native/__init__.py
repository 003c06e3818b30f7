"""Host C++ runtime of the port, loaded with ctypes: the RLE mask code.

Port of kgdet_tpu/native/__init__.py. ``maskops.cpp`` (the port's own copy
of kgdet_tpu/native/maskops.cpp) holds the COCO mask API: RLE encode,
decode, merge, area, IoU, bounding box, string coding and polygon
rasterizing, the behavioural equivalent of pycocotools' C core. It runs on
the host, not on the card.

It is compiled at first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
the git-ignored ``kgdet_tpu_torch/build/maskops-<hash>/libmaskops.so``,
``<hash>`` a digest of the source, so an edited source builds anew. The
build writes a pid-unique temporary file and renames it into place, so
processes that build at once (pytest-xdist workers, data-parallel ranks)
do not interleave. Where ``g++`` is missing the build raises naming it;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / 'maskops.cpp'
BUILD = Path(__file__).resolve().parent.parent / 'build'
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD / f'maskops-{digest}' / 'libmaskops.so'


def build(so: Path) -> None:
    """Compile maskops.cpp into ``so`` with g++, through a temporary name
    unique to this process."""
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError(
            'the RLE mask code (kgdet_tpu_torch/native/maskops.cpp) is '
            'built with g++, and no g++ is on PATH')
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    cmd = [gxx, '-O3', '-shared', '-fPIC', '-std=c++17', str(SRC), '-o',
           str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f'g++ failed to build {SRC.name}:\n{res.stderr}')
    os.replace(tmp, so)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            build(so)
        lib = ctypes.CDLL(str(so))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        dp = ctypes.POINTER(ctypes.c_double)
        i = ctypes.c_int
        sigs = {
            'rle_encode': (i, [u8p, i, i, u32p]),
            'rle_decode': (i, [u32p, i, i, i, u8p]),
            'rle_area': (ctypes.c_uint64, [u32p, i]),
            'rle_to_bbox': (None, [u32p, i, i, i, dp]),
            'rle_merge': (i, [u32p, i, u32p, i, i, u32p]),
            'rle_iou': (ctypes.c_double, [u32p, i, u32p, i, i, i, i]),
            'rle_to_string': (i, [u32p, i, ctypes.c_char_p]),
            'rle_from_string': (i, [ctypes.c_char_p, i, u32p]),
            'poly_to_rle': (i, [dp, i, i, i, u32p]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


def _u32(a):
    return np.ascontiguousarray(a, dtype=np.uint32)


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


class RLE:
    """A run-length-encoded binary mask (column-major counts)."""

    __slots__ = ('h', 'w', 'counts')

    def __init__(self, h, w, counts):
        self.h = int(h)
        self.w = int(w)
        self.counts = _u32(counts)

    @classmethod
    def encode(cls, mask: np.ndarray) -> 'RLE':
        """Encode an (h, w) binary mask."""
        lib = _load()
        h, w = mask.shape
        fmask = np.ascontiguousarray(
            np.asarray(mask, dtype=np.uint8).reshape(-1, order='F'))
        out = np.empty(h * w + 1, np.uint32)
        m = lib.rle_encode(_ptr(fmask, ctypes.c_uint8), h, w,
                           _ptr(out, ctypes.c_uint32))
        return cls(h, w, out[:m])

    @classmethod
    def from_string(cls, s, h, w) -> 'RLE':
        lib = _load()
        if isinstance(s, str):
            s = s.encode()
        out = np.empty(len(s) + 1, np.uint32)
        m = lib.rle_from_string(s, len(s), _ptr(out, ctypes.c_uint32))
        return cls(h, w, out[:m])

    @classmethod
    def from_poly(cls, xy, h, w) -> 'RLE':
        lib = _load()
        xy = np.ascontiguousarray(xy, dtype=np.float64).reshape(-1)
        out = np.empty(h * w + 1, np.uint32)
        m = lib.poly_to_rle(_ptr(xy, ctypes.c_double), len(xy) // 2, h, w,
                            _ptr(out, ctypes.c_uint32))
        return cls(h, w, out[:m])

    def decode(self) -> np.ndarray:
        lib = _load()
        out = np.zeros(self.h * self.w, np.uint8)
        if lib.rle_decode(_ptr(self.counts, ctypes.c_uint32),
                          len(self.counts), self.h, self.w,
                          _ptr(out, ctypes.c_uint8)):
            raise ValueError('invalid RLE: counts do not cover h*w')
        return out.reshape(self.h, self.w, order='F')

    def area(self) -> int:
        lib = _load()
        return int(lib.rle_area(_ptr(self.counts, ctypes.c_uint32),
                                len(self.counts)))

    def to_bbox(self) -> np.ndarray:
        lib = _load()
        bb = np.zeros(4, np.float64)
        lib.rle_to_bbox(_ptr(self.counts, ctypes.c_uint32),
                        len(self.counts), self.h, self.w,
                        _ptr(bb, ctypes.c_double))
        return bb

    def to_string(self) -> bytes:
        lib = _load()
        buf = ctypes.create_string_buffer(6 * len(self.counts) + 1)
        n = lib.rle_to_string(_ptr(self.counts, ctypes.c_uint32),
                              len(self.counts), buf)
        return buf.raw[:n]

    def merge(self, other: 'RLE', intersect: bool = False) -> 'RLE':
        lib = _load()
        out = np.empty(self.h * self.w + 1, np.uint32)
        m = lib.rle_merge(
            _ptr(self.counts, ctypes.c_uint32), len(self.counts),
            _ptr(other.counts, ctypes.c_uint32), len(other.counts),
            1 if intersect else 0, _ptr(out, ctypes.c_uint32))
        return RLE(self.h, self.w, out[:m])

    def iou(self, other: 'RLE', iscrowd: bool = False) -> float:
        lib = _load()
        return float(lib.rle_iou(
            _ptr(self.counts, ctypes.c_uint32), len(self.counts),
            _ptr(other.counts, ctypes.c_uint32), len(other.counts),
            1 if iscrowd else 0, self.h, self.w))


def mask_iou_matrix(dts, gts, iscrowd=None):
    """IoU matrix between lists of RLEs (crowd GTs use IoF)."""
    iscrowd = iscrowd or [False] * len(gts)
    out = np.zeros((len(dts), len(gts)))
    for i, d in enumerate(dts):
        for j, g in enumerate(gts):
            out[i, j] = d.iou(g, iscrowd[j])
    return out
