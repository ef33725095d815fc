"""PyTorch/CUDA port of zstdsharp_tpu, a Zstandard (RFC 8878) codec.

The public API is the JAX package's, name for name (``import
zstdsharp_tpu_torch as z`` in its place gives the same bytes and the same
``ZstdErrorCode``s):

    compress(data, level=3) -> bytes
    decompress(data, max_output_size=...) -> bytes
    Compressor, Decompressor
    CompressionStream, DecompressionStream
    train_dictionary(samples, dict_size)
    ZstdError

The record-batch decode path (``Decompressor.unwrap_many_device`` ->
``decode.device_pipeline.decode_batch_device``) runs on an NVIDIA GPU
through hand-written CUDA kernels for Huffman literal decode and FSE
sequence decode (``csrc/``), with the LZ executor in torch.  The
record-batch encode path (``encode.device_pipeline.compress_batch_device``)
runs the greedy parse, FSE and Huffman coding and frame assembly in torch,
with its literal byte histogram as a hand-written CUDA kernel.  These
entry points run on the card unless the caller names another device; on
CPU tensors every kernel wrapper runs its plain torch version instead.

The port stands alone: its host tier (frame codec, streams, dictionaries
and their trainer, the Python block encoder, the native engine's ctypes
binding of native/zstdtpu_core.cpp) is its own copy of the reference's,
and nothing here imports JAX or the ``zstdsharp_tpu`` package.
Importing this package initialises no CUDA state and builds nothing: the
kernels are compiled with nvcc on first use (``_build.py``).
"""

from .errors import ZstdError, ZstdErrorCode

__version__ = "0.1.0"

__all__ = [
    "ZstdError",
    "ZstdErrorCode",
    "compress",
    "decompress",
    "compress_bound",
    "Compressor",
    "Decompressor",
    "CompressionStream",
    "DecompressionStream",
    "train_dictionary",
    "finalize_dictionary",
    "optimize_train_from_buffer",
    "ZstdCompressionDict",
    "__version__",
]


def __getattr__(name):
    # Lazy imports keep `import zstdsharp_tpu_torch` light (no torch or
    # engine load until a name is used).
    if name in ("decompress", "Decompressor", "frame_info", "decompress_bound"):
        from .decode import frame as _f

        return getattr(_f, name)
    if name in ("compress", "compress_bound", "Compressor"):
        from .encode import frame as _f

        return getattr(_f, name)
    if name in ("CompressionStream", "DecompressionStream"):
        from . import streaming as _s

        return getattr(_s, name)
    if name in ("train_dictionary", "finalize_dictionary",
                "optimize_train_from_buffer", "ZstdCompressionDict"):
        from . import dictionary as _d

        return getattr(_d, name)
    raise AttributeError(name)
