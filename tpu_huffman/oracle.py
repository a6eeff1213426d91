"""ctypes bindings to the C++ host codec (cpp/), the bit-exact oracle.

The C++ library mirrors the reference semantics exactly (see
cpp/include/tpuhuff/tpuhuff.hpp); tests compare every device path against it,
and the benchmark uses it as the CPU baseline — the role the C reference
plays in BASELINE.md.

The shared library is built on demand with g++ (no cmake round trip needed
for tests); ``cmake`` remains the canonical build (cpp/CMakeLists.txt).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .errors import ShortBufferError, UnknownSymbolError
from .tables import HuffmanTable

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
_LIB_PATH = os.path.join(_CPP_DIR, "build", "libtpuhuff.so")

_OK, _SHORT_BUFFER, _UNKNOWN_SYMBOL = 0, 1, 2

_build_lock = threading.Lock()
_lib = None


def _build_lib() -> str:
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    cmd = [
        "g++", "-std=c++17", "-O2", "-fPIC", "-shared",
        "-I", os.path.join(_CPP_DIR, "include"),
        os.path.join(_CPP_DIR, "src", "tpuhuff.cpp"),
        os.path.join(_CPP_DIR, "src", "capi.cpp"),
        "-o", _LIB_PATH,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        srcs = [
            os.path.join(_CPP_DIR, "src", "tpuhuff.cpp"),
            os.path.join(_CPP_DIR, "src", "capi.cpp"),
            os.path.join(_CPP_DIR, "include", "tpuhuff", "tpuhuff.hpp"),
        ]
        if not os.path.exists(_LIB_PATH) or any(
            os.path.getmtime(s) > os.path.getmtime(_LIB_PATH) for s in srcs
        ):
            _build_lib()
        lib = ctypes.CDLL(_LIB_PATH)

        lib.th_table_create.restype = ctypes.c_void_p
        lib.th_table_create.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ]
        lib.th_table_destroy.argtypes = [ctypes.c_void_p]
        lib.th_encoder_create.restype = ctypes.c_void_p
        lib.th_encoder_create.argtypes = [ctypes.c_void_p, ctypes.c_uint8]
        lib.th_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.th_encoder_reset.argtypes = [ctypes.c_void_p]
        lib.th_encoder_carry_pattern.restype = ctypes.c_uint32
        lib.th_encoder_carry_pattern.argtypes = [ctypes.c_void_p]
        lib.th_encoder_carry_len.restype = ctypes.c_uint8
        lib.th_encoder_carry_len.argtypes = [ctypes.c_void_p]
        lib.th_encoded_length.restype = ctypes.c_uint64
        lib.th_encoded_length.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.th_encode.restype = ctypes.c_int
        lib.th_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, u64p,
            ctypes.c_char_p, ctypes.c_uint64, u64p,
        ]
        lib.th_decoder_create.restype = ctypes.c_void_p
        lib.th_decoder_create.argtypes = [ctypes.c_void_p]
        lib.th_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.th_decoder_reset.argtypes = [ctypes.c_void_p]
        lib.th_decoder_working_bits.restype = ctypes.c_uint64
        lib.th_decoder_working_bits.argtypes = [ctypes.c_void_p]
        lib.th_decoder_num_bits.restype = ctypes.c_uint8
        lib.th_decoder_num_bits.argtypes = [ctypes.c_void_p]
        lib.th_decode.restype = ctypes.c_int
        lib.th_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, u64p,
            ctypes.c_char_p, ctypes.c_uint64, u64p,
        ]
        _lib = lib
        return lib


class OracleTable:
    """C++-side compiled table built from a Python HuffmanTable's specs."""

    def __init__(self, table: HuffmanTable, root_bits: int | None = None):
        lib = _load()
        specs = table.specs()
        n = len(specs)
        syms = (ctypes.c_uint16 * n)(*[s.symbol for s in specs])
        lens = (ctypes.c_uint8 * n)(*[s.num_bits for s in specs])
        pats = (ctypes.c_uint32 * n)(*[s.pattern for s in specs])
        self._lib = lib
        self._ptr = lib.th_table_create(
            syms, lens, pats, n, root_bits if root_bits is not None else table.root_bits
        )
        if not self._ptr:
            raise ValueError("C++ table rejected the specs")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.th_table_destroy(self._ptr)
            self._ptr = None


class OracleEncoder:
    """Streaming encoder over the C++ oracle (reference-shaped API)."""

    def __init__(self, otable: OracleTable, eos_padding: int = 0xFF):
        self._lib = _load()
        self._table = otable  # keep alive
        self._ptr = self._lib.th_encoder_create(otable._ptr, eos_padding)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.th_encoder_destroy(self._ptr)
            self._ptr = None

    def reset(self) -> None:
        self._lib.th_encoder_reset(self._ptr)

    @property
    def overflow_bits(self) -> tuple[int, int]:
        return (
            int(self._lib.th_encoder_carry_pattern(self._ptr)),
            int(self._lib.th_encoder_carry_len(self._ptr)),
        )

    def encoded_length(self, data: bytes) -> int:
        return int(self._lib.th_encoded_length(self._ptr, bytes(data), len(data)))

    def encode_chunk(self, data: bytes, capacity: int) -> tuple[bytes, int, bool]:
        """Returns (out_bytes, consumed, done)."""
        out = ctypes.create_string_buffer(capacity)
        consumed = ctypes.c_uint64()
        written = ctypes.c_uint64()
        st = self._lib.th_encode(
            self._ptr, bytes(data), len(data), ctypes.byref(consumed),
            out, capacity, ctypes.byref(written),
        )
        if st == _UNKNOWN_SYMBOL:
            raise UnknownSymbolError()
        return out.raw[: written.value], int(consumed.value), st == _OK

    def encode(self, data: bytes) -> bytes:
        out, _, done = self.encode_chunk(data, self.encoded_length(data) + 8)
        assert done
        return out


class OracleDecoder:
    """Streaming decoder over the C++ oracle."""

    def __init__(self, otable: OracleTable):
        self._lib = _load()
        self._table = otable
        self._ptr = self._lib.th_decoder_create(otable._ptr)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.th_decoder_destroy(self._ptr)
            self._ptr = None

    def reset(self) -> None:
        self._lib.th_decoder_reset(self._ptr)

    @property
    def leftover_bits(self) -> tuple[int, int]:
        """(working_bits MSB-aligned value, num_bits)."""
        return (
            int(self._lib.th_decoder_working_bits(self._ptr)),
            int(self._lib.th_decoder_num_bits(self._ptr)),
        )

    def decode_chunk(self, data: bytes, capacity: int) -> tuple[bytes, int, bool]:
        """Returns (out_bytes, in_consumed, done)."""
        out = ctypes.create_string_buffer(max(capacity, 1))
        consumed = ctypes.c_uint64()
        written = ctypes.c_uint64()
        st = self._lib.th_decode(
            self._ptr, bytes(data), len(data), ctypes.byref(consumed),
            out, capacity, ctypes.byref(written),
        )
        if st == _UNKNOWN_SYMBOL:
            raise UnknownSymbolError()
        return out.raw[: written.value], int(consumed.value), st == _OK

    def decode(self, data: bytes) -> bytes:
        """One-shot decode with internal growth (allow_growth semantics)."""
        chunks = []
        pending = bytes(data)
        cap = max(len(data) * 2, 64)
        while True:
            out, consumed, done = self.decode_chunk(pending, cap)
            chunks.append(out)
            pending = pending[consumed:]
            if done and not pending:
                return b"".join(chunks)
            if done and consumed == 0 and not out:
                # Ok status with unconsumed input and zero progress would
                # spin forever; surface it instead (cannot happen with a
                # spec-conforming decoder, but guard the loop).
                raise RuntimeError(
                    "C++ decoder returned Ok without consuming input"
                )


def oracle_encode(data: bytes, table: HuffmanTable, eos_padding: int = 0xFF) -> bytes:
    """One-shot encode through the C++ oracle."""
    return OracleEncoder(OracleTable(table), eos_padding).encode(data)


def oracle_decode(data: bytes, table: HuffmanTable) -> bytes:
    """One-shot decode through the C++ oracle."""
    return OracleDecoder(OracleTable(table)).decode(data)


def oracle_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False
