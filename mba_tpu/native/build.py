"""Build + ctypes bindings for the native serial shim."""
from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path

_SRC = Path(__file__).parent / "serialshim.cpp"
_LIB = Path(__file__).parent / "_serialshim.so"
_QSRC = Path(__file__).parent / "quantshim.cpp"
_QLIB = Path(__file__).parent / "_quantshim.so"


class Sample(ctypes.Structure):
    _fields_ = [("fsr", ctypes.c_double), ("ecg", ctypes.c_double),
                ("gsr", ctypes.c_double), ("t_mono", ctypes.c_double),
                ("seq", ctypes.c_uint64)]


def _compile() -> Path:
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(_LIB)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return _LIB


_quantshim_failed = False


@functools.lru_cache(maxsize=1)
def load_quantshim() -> ctypes.CDLL:
    """Compile (once) and load the native per-channel quantizer.

    Raises on hosts without a working g++; callers fall back to numpy.
    The failure is memoized (lru_cache does not cache exceptions) so the
    compile is not retried on every quantize call.
    """
    global _quantshim_failed
    if _quantshim_failed:
        raise RuntimeError("quantshim build failed earlier this session")
    try:
        if (not _QLIB.exists()
                or _QLIB.stat().st_mtime < _QSRC.stat().st_mtime):
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-std=c++17", str(_QSRC), "-o", str(_QLIB)]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(_QLIB))
    except Exception:
        _quantshim_failed = True
        raise
    lib.quantize_i16_per_col.restype = None
    lib.quantize_i16_per_col.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_int16)]
    lib.quantize_i8_per_col.restype = None
    lib.quantize_i8_per_col.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_int8)]
    return lib


def _quantize_per_channel(x, bits: int):
    import numpy as np
    full = 32767.0 if bits == 16 else 127.0
    dtype = np.int16 if bits == 16 else np.int8
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim < 2:
        raise ValueError("expected (..., n_samples, n_channels)")
    try:
        lib = load_quantshim()
    except Exception:
        peak = np.maximum(np.abs(x).max(axis=-2, keepdims=True),
                          np.float32(1e-30))
        return np.round(x * (full / peak)).astype(dtype)
    out = np.empty(x.shape, dtype)
    flat_x = x.reshape((-1,) + x.shape[-2:])
    flat_o = out.reshape((-1,) + x.shape[-2:])
    fp = ctypes.POINTER(ctypes.c_float)
    fn = (lib.quantize_i16_per_col if bits == 16
          else lib.quantize_i8_per_col)
    ip = ctypes.POINTER(ctypes.c_int16 if bits == 16 else ctypes.c_int8)
    for i in range(flat_x.shape[0]):
        fn(flat_x[i].ctypes.data_as(fp), flat_x.shape[1],
           flat_x.shape[2], flat_o[i].ctypes.data_as(ip))
    return out


def quantize_int16_per_channel(x) -> "np.ndarray":
    """Quantize (..., n_samples, n_channels) float32 to int16 with
    per-(leading-dims, channel) peak scaling.

    The scaling cancels exactly in MSC, so the only error is the int16
    rounding of the signal (<= 2^-15 of each channel's peak).  Uses the
    native SIMD quantizer when it builds; numpy fallback is
    bit-identical (both round half-to-even).
    """
    return _quantize_per_channel(x, 16)


def quantize_int8_per_channel(x) -> "np.ndarray":
    """int8 variant: quarter the upload bytes of float32, rounding
    error <= 2^-7 of each channel's peak.  For null engines the induced
    statistic perturbation is below Monte-Carlo noise at practical
    surrogate counts (tested); prefer int16 when the transfer affords it.
    """
    return _quantize_per_channel(x, 8)


@functools.lru_cache(maxsize=1)
def load_serialshim() -> ctypes.CDLL:
    """Compile (once) and load the native serial shim."""
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        _compile()
    lib = ctypes.CDLL(str(_LIB))
    lib.parser_create.restype = ctypes.c_void_p
    lib.parser_create.argtypes = [ctypes.c_uint32]
    lib.parser_destroy.argtypes = [ctypes.c_void_p]
    lib.parser_feed.restype = ctypes.c_uint64
    lib.parser_feed.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_uint32, ctypes.c_double]
    lib.parser_poll.restype = ctypes.c_uint32
    lib.parser_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(Sample),
                                ctypes.c_uint32]
    lib.parser_dropped.restype = ctypes.c_uint64
    lib.parser_dropped.argtypes = [ctypes.c_void_p]
    lib.parser_pending.restype = ctypes.c_uint64
    lib.parser_pending.argtypes = [ctypes.c_void_p]
    lib.serial_open.restype = ctypes.c_int
    lib.serial_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.serial_read_into_parser.restype = ctypes.c_int
    lib.serial_read_into_parser.argtypes = [ctypes.c_int,
                                            ctypes.c_void_p,
                                            ctypes.c_double]
    lib.serial_write_byte.restype = ctypes.c_int
    lib.serial_write_byte.argtypes = [ctypes.c_int, ctypes.c_uint8]
    lib.serial_close.argtypes = [ctypes.c_int]
    return lib


class NativeLineParser:
    """Pythonic wrapper over the C++ ring-buffer parser."""

    def __init__(self, capacity: int = 8192):
        self._lib = load_serialshim()
        self._handle = self._lib.parser_create(capacity)
        if not self._handle:
            raise MemoryError("parser_create failed")

    def feed(self, data: bytes, t_mono: float = 0.0) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return int(self._lib.parser_feed(self._handle, buf, len(data),
                                         t_mono))

    def poll(self, max_out: int = 1024) -> list[dict]:
        out = (Sample * max_out)()
        n = self._lib.parser_poll(self._handle, out, max_out)
        return [{"fsr": out[i].fsr, "ecg": out[i].ecg,
                 "gsr": out[i].gsr, "t_mono": out[i].t_mono,
                 "seq": out[i].seq} for i in range(n)]

    @property
    def dropped(self) -> int:
        return int(self._lib.parser_dropped(self._handle))

    @property
    def pending(self) -> int:
        return int(self._lib.parser_pending(self._handle))

    def __del__(self):
        try:
            self._lib.parser_destroy(self._handle)
        except Exception:
            pass
