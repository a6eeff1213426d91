"""Error types for the Huffman codec.

Mirrors the reference library's error surface (reference:
include/aws/compression/compression.h:17-21 defines
AWS_ERROR_COMPRESSION_UNKNOWN_SYMBOL; AWS_ERROR_SHORT_BUFFER is raised from
source/huffman.c:98,151,163,266). In this framework the two conditions are
Python exceptions; device kernels report them via validity flags that the
host wrappers convert into raises.
"""

from __future__ import annotations


class CompressionError(Exception):
    """Base class for all codec errors."""


class UnknownSymbolError(CompressionError):
    """A symbol with no code in the table was encountered.

    Equivalent of AWS_ERROR_COMPRESSION_UNKNOWN_SYMBOL
    (reference: source/huffman.c:63 on encode, source/huffman.c:246 on decode).
    """

    def __init__(self, index: int | None = None, symbol: int | None = None):
        self.index = index
        self.symbol = symbol
        loc = "" if index is None else f" at input index {index}"
        sym = "" if symbol is None else f" (symbol {symbol})"
        super().__init__(f"unknown symbol{sym}{loc}")


class ShortBufferError(CompressionError):
    """Output buffer capacity exhausted; call again with more room.

    Equivalent of AWS_ERROR_SHORT_BUFFER in the streaming protocol
    (reference: source/huffman.c:98,151,163,266). The codec state retains
    everything needed to resume; this is a control-flow signal, not a
    data-loss condition.
    """


class TableError(CompressionError):
    """A symbol table failed validation (not prefix-free, bad lengths...)."""
