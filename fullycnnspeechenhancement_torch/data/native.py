"""ctypes binding for the native host runtime (`runtime/*.cc`).

The port's copy of `fullycnnspeechenhancement_tpu/data/native.py`, over
the port's own copies of the runtime sources (`runtime/fcse_runtime.cc`,
`runtime/pesq862.cc`, the JAX package's code line for line): WAV decode,
scipy-compatible polyphase resampling, reference-semantics SNR mixing and
the P.862-structured PESQ.  ctypes calls release the GIL, so the
thread-pool loader decodes in parallel.

The library is built on first use: `g++` with the JAX package's
`runtime/Makefile` flags, into `ops/build/` (gitignored) under a name
keyed on a hash of both sources, the flags and the host's target (the
flags hold `-march=native`), written to a temporary file and then
renamed, so processes that build at once each see all of it or nothing.
Where `g++` is missing or the build fails, `native_available()` is False
and every entry point raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fullycnnspeechenhancement_torch.ops.build import BUILD_DIR

logger = logging.getLogger(__name__)

RUNTIME_DIR = Path(__file__).resolve().parent.parent / "runtime"
SOURCES = ("fcse_runtime.cc", "pesq862.cc")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_key = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native runtime is built from source on first use")
    return cxx


def _build_key() -> str:
    """A hash of both sources, the flags and the target `-march=native`
    resolves to on this host, so a library built on another machine is
    rebuilt rather than loaded.  Raises where `g++` is missing."""
    global _key
    if _key is None:
        target = subprocess.run(
            [_cxx(), "-march=native", "-Q", "--help=target"], capture_output=True, text=True, check=True,
        ).stdout
        digest = hashlib.sha256()
        for name in SOURCES:
            digest.update((RUNTIME_DIR / name).read_bytes())
        digest.update(" ".join(CXXFLAGS).encode())
        digest.update(target.encode())
        _key = digest.hexdigest()[:16]
    return _key


def library_path() -> Path:
    return BUILD_DIR / f"libfcse_runtime-{_build_key()}.so"


def build() -> Path:
    """Compile the runtime unless its library exists; returns its path.
    Raises when `g++` is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_cxx(), *CXXFLAGS, "-o", tmp, *(str(RUNTIME_DIR / n) for n in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed on the native runtime ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _load():
    """The loaded library, built first if need be; None when it cannot be.
    No lock: threads or processes racing here each build to their own
    temporary file (see `build`), and a forked scorer never waits on a lock
    its parent held."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
        logger.warning("native runtime unavailable: %s", e)
        return None
    _declare(lib)
    _lib = lib
    return lib


def _declare(lib) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fcse_decode_wav.restype = ctypes.c_int
    lib.fcse_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(f32p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fcse_resample.restype = ctypes.c_int
    lib.fcse_resample.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(f32p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fcse_mix_at_snr.restype = ctypes.c_int
    lib.fcse_mix_at_snr.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_uint64, f32p,
    ]
    lib.fcse_prepare_item.restype = ctypes.c_int
    lib.fcse_prepare_item.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_double,
        ctypes.c_uint64, ctypes.POINTER(f32p), ctypes.POINTER(f32p),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fcse_free.restype = None
    lib.fcse_free.argtypes = [f32p]
    lib.fcse_pesq_nb.restype = ctypes.c_double
    lib.fcse_pesq_nb.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64]
    lib.fcse_pesq_nb_ind.restype = ctypes.c_double
    lib.fcse_pesq_nb_ind.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]


def native_available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime not built")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _take(lib, ptr, n) -> np.ndarray:
    out = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.fcse_free(ptr)
    return out


def decode_wav(path: str) -> Tuple[np.ndarray, int]:
    lib = _require()
    ptr = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = lib.fcse_decode_wav(path.encode(), ctypes.byref(ptr), ctypes.byref(n), ctypes.byref(sr))
    if rc:
        raise IOError(f"fcse_decode_wav({path}) failed: rc={rc}")
    return _take(lib, ptr, n.value), int(sr.value)


def resample(signal: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    lib = _require()
    x = np.ascontiguousarray(signal, np.float32)
    ptr = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.fcse_resample(_ptr(x), len(x), sr, target_sr, ctypes.byref(ptr), ctypes.byref(n))
    if rc:
        raise RuntimeError(f"fcse_resample failed: rc={rc}")
    return _take(lib, ptr, n.value)


def mix_at_snr(speech: np.ndarray, noise: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    lib = _require()
    s = np.ascontiguousarray(speech, np.float32)
    nz = np.ascontiguousarray(noise, np.float32)
    out = np.empty_like(s)
    rc = lib.fcse_mix_at_snr(_ptr(s), len(s), _ptr(nz), len(nz), snr_db, seed, _ptr(out))
    if rc:
        raise RuntimeError(f"fcse_mix_at_snr failed: rc={rc}")
    return out


def pesq_nb(reference: np.ndarray, degraded: np.ndarray, return_indicators: bool = False):
    """P.862-structured narrowband PESQ (runtime/pesq862.cc).

    Inputs: mono float signals at 8 kHz.  Returns the MOS-scale score in
    [-0.5, 4.5]; with return_indicators=True, (score, D, DA): the raw
    symmetric and asymmetric disturbance indicators.  Not bit-compatible
    with the ITU reference implementation (see pesq862.cc's header), but a
    perceptual model of the same family, calibrated on anchor conditions.
    """
    lib = _require()
    a = np.ascontiguousarray(reference, np.float32)
    b = np.ascontiguousarray(degraded, np.float32)
    d = ctypes.c_double()
    da = ctypes.c_double()
    score = lib.fcse_pesq_nb_ind(_ptr(a), len(a), _ptr(b), len(b), ctypes.byref(d), ctypes.byref(da))
    if score < -100.0:
        raise ValueError(f"fcse_pesq_nb failed: rc={score}")
    if return_indicators:
        return float(score), float(d.value), float(da.value)
    return float(score)


def prepare_item(
    clean_path: str,
    noise_path: Optional[str],
    target_sr: int,
    snr_db: float,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused decode + resample (+ mix): -> (mix, clean).  Releases the GIL
    for the whole item, so thread-pool loading runs in parallel."""
    lib = _require()
    mix_ptr = ctypes.POINTER(ctypes.c_float)()
    clean_ptr = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.fcse_prepare_item(
        clean_path.encode(), (noise_path or "").encode(), target_sr, snr_db, seed,
        ctypes.byref(mix_ptr), ctypes.byref(clean_ptr), ctypes.byref(n),
    )
    if rc:
        raise IOError(f"fcse_prepare_item({clean_path}, {noise_path}) failed: rc={rc}")
    return _take(lib, mix_ptr, n.value), _take(lib, clean_ptr, n.value)
