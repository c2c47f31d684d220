"""ctypes binding of the port's FFmpeg decoder (tvts_torch/cpp/decoder.cc;
counterpart of tvts_tpu/data/native_decoder.py).

The shared library is built at first use with g++ and pkg-config's FFmpeg
flags into tvts_torch/_build/ (one compile, a few seconds). Where g++,
pkg-config or FFmpeg's development files are missing the build fails and
`available()` is False; the video reader then takes OpenCV.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "cpp" / "decoder.cc"
_BUILD = _PKG / "_build"
_FFMPEG = ("libavformat", "libavcodec", "libavutil", "libswscale")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


@dataclasses.dataclass
class VideoInfo:
    n_frames: int
    duration: float
    width: int
    height: int
    fps: float


def build() -> Path:
    """Compile decoder.cc into tvts_torch/_build/ unless a library built from
    the same source and flags is there. Raises RuntimeError naming what is
    missing, or with the compiler's output."""
    cxx, pkg_config = shutil.which(os.environ.get("CXX", "g++")), shutil.which("pkg-config")
    if cxx is None or pkg_config is None:
        raise RuntimeError("native decoder: needs g++ and pkg-config on PATH")
    flags = subprocess.run([pkg_config, "--cflags", "--libs", *_FFMPEG], capture_output=True,
                           text=True)
    if flags.returncode:
        first = (flags.stderr.strip().splitlines() or [""])[0]
        raise RuntimeError(f"native decoder: pkg-config finds no FFmpeg development files "
                           f"({', '.join(_FFMPEG)}): {first}")
    command = [cxx, "-O3", "-fPIC", "-shared", "-std=c++17", str(_SOURCE), *flags.stdout.split()]
    digest = hashlib.sha256(" ".join(command).encode() + _SOURCE.read_bytes()).hexdigest()
    lib_path = _BUILD / f"libtvtsdecode_{digest[:16]}.so"
    if lib_path.exists():
        return lib_path
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"libtvtsdecode.{os.getpid()}.so"  # per process: concurrent builds never collide
    proc = subprocess.run([*command, "-o", str(tmp)], capture_output=True, text=True, timeout=300)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native decoder: g++ failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees a partial file
    return lib_path


def _load():
    """The bound library, building it once; None where it cannot be built."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = build()
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as err:
            _build_error = str(err)
            return None
        lib = ctypes.CDLL(str(path))
        i64p, dp, ip = (ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
                        ctypes.POINTER(ctypes.c_int))
        u8p, c_int = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
        lib.tvts_probe.argtypes = [ctypes.c_char_p, i64p, dp, ip, ip, dp]
        lib.tvts_probe.restype = c_int
        lib.tvts_decode.argtypes = [ctypes.c_char_p, i64p, c_int, c_int, c_int, u8p]
        lib.tvts_decode.restype = c_int
        lib.tvts_decode_aug.argtypes = [ctypes.c_char_p, i64p, *[c_int] * 8, u8p]
        lib.tvts_decode_aug.restype = c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """Why the library could not be built (None when it is available or was
    not tried yet)."""
    _load()
    return _build_error


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    return lib


def probe(path: str) -> VideoInfo:
    lib = _library()
    n, dur, fps = ctypes.c_int64(), ctypes.c_double(), ctypes.c_double()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.tvts_probe(os.fsencode(path), ctypes.byref(n), ctypes.byref(dur),
                        ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps))
    if rc != 0:
        raise IOError(f"tvts_probe failed ({rc}) for {path}")
    return VideoInfo(int(n.value), float(dur.value), int(w.value), int(h.value),
                     float(fps.value))


def _indices(frame_idxs) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(frame_idxs, dtype=np.int64))


def decode_frames(path: str, frame_idxs, resize: tuple[int, int] | None = None
                  ) -> np.ndarray:
    """Decode the given frames -> uint8 [T, H, W, 3] RGB; resize=(w, h) optional."""
    lib = _library()
    idxs = _indices(frame_idxs)
    if resize is not None:
        out_w, out_h = resize
    else:
        info = probe(path)
        out_w, out_h = info.width, info.height
    out = np.empty((len(idxs), out_h, out_w, 3), dtype=np.uint8)
    rc = lib.tvts_decode(os.fsencode(path), idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         len(idxs), out_w, out_h,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"tvts_decode failed ({rc}) for {path}")
    return out


def decode_frames_aug(path: str, frame_idxs, crop_size: int,
                      crop_frac: tuple[float, float] = (0.5, 0.5),
                      hflip: bool = False,
                      resize: tuple[int, int] | None = None) -> np.ndarray:
    """Decode with the crop and horizontal flip done in the decoder (the
    reference's ffmpeg-filtergraph `fast_decode`, base_dataset_yt.py:394-436):
    a crop_size x crop_size window at fractional position (aw, ah) of the
    slack, mirrored if `hflip`. Returns uint8 [T, H, W, 3] RGB."""
    lib = _library()
    info = probe(path)
    aw, ah = crop_frac
    cw, ch = min(crop_size, info.width), min(crop_size, info.height)
    cx, cy = int((info.width - cw) * aw), int((info.height - ch) * ah)
    out_w, out_h = resize if resize is not None else (cw, ch)
    idxs = _indices(frame_idxs)
    out = np.empty((len(idxs), out_h, out_w, 3), dtype=np.uint8)
    rc = lib.tvts_decode_aug(
        os.fsencode(path), idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idxs),
        cx, cy, cw, ch, out_w, out_h, int(hflip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"tvts_decode_aug failed ({rc}) for {path}")
    return out
