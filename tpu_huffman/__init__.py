"""tpu_huffman: a data-parallel static-Huffman lossless codec in JAX.

A JAX/XLA/Pallas framework with the capabilities of
awslabs/aws-c-compression: streaming static-Huffman encode/decode with
pluggable symbol tables, an offline table compiler, a chunked
(SHORT_BUFFER-equivalent) resume protocol, and data-parallel scaling over
device meshes; its parallel decode runs a Pallas kernel compiled through
Triton on NVIDIA GPUs. A C++17 host library (cpp/) mirrors the reference
semantics bit-for-bit as the CPU oracle and baseline.

Layer map (vs SURVEY.md §1):
  1. library runtime  -> library_init/clean_up + errors (errors.py)
  2. codec core       -> ops/encode.py, ops/decode.py, ops/selfsync.py,
                         ops/lanes.py, stream.py
  3. symbol coder     -> tables.HuffmanTable (tables as data, not codegen)
  4. generator tool   -> tables.py parser/compiler + cpp/tools/huffgen
"""

from __future__ import annotations

from .errors import (
    CompressionError,
    ShortBufferError,
    TableError,
    UnknownSymbolError,
)
from .ops import (
    BlockIndex,
    decode,
    decode_indexed,
    encode,
    encode_with_index,
    get_encoded_length,
)
from .shard import MeshCodec, default_mesh
from .stream import DecodeResult, EncodeResult, HuffmanDecoder, HuffmanEncoder
from .tables import (
    CodeSpec,
    HuffmanTable,
    build_table,
    load_hpack_table,
    load_static_test_table,
    make_canonical,
    optimal_code_lengths,
    safe_eos_padding,
)

__version__ = "0.1.0"

_library_initialized = False


def library_init() -> None:
    """Parity with aws_compression_library_init (reference:
    source/compression.c:26-34). Idempotent; in this framework errors are
    Python exception types, so init only flips the guard and warms nothing.
    """
    global _library_initialized
    _library_initialized = True


def library_clean_up() -> None:
    """Parity with aws_compression_library_clean_up (reference:
    source/compression.c:36-44)."""
    global _library_initialized
    _library_initialized = False


def library_is_initialized() -> bool:
    return _library_initialized


__all__ = [
    "BlockIndex",
    "CodeSpec",
    "CompressionError",
    "DecodeResult",
    "EncodeResult",
    "HuffmanDecoder",
    "HuffmanEncoder",
    "HuffmanTable",
    "MeshCodec",
    "ShortBufferError",
    "TableError",
    "UnknownSymbolError",
    "build_table",
    "decode",
    "decode_indexed",
    "default_mesh",
    "encode",
    "encode_with_index",
    "get_encoded_length",
    "library_clean_up",
    "library_init",
    "library_is_initialized",
    "load_hpack_table",
    "load_static_test_table",
    "make_canonical",
    "optimal_code_lengths",
    "safe_eos_padding",
]
