"""PyTorch/CUDA port of the zstdsharp_tpu device decode and encode planes.

The record-batch decode path (``decode.frame.Decompressor.unwrap_many_device``
-> ``decode.device_pipeline.decode_batch_device``) runs on an NVIDIA GPU
through hand-written CUDA kernels for Huffman literal decode and FSE
sequence decode (``csrc/``), with the LZ executor in torch.  The
record-batch encode path (``encode.device_pipeline.compress_batch_device``)
runs the greedy parse, FSE and Huffman coding and frame assembly in torch,
with its literal byte histogram as a hand-written CUDA kernel.  On CPU
tensors every kernel wrapper runs its plain torch version instead.

The port stands alone: its host tier (frame parsing and the host codec,
entropy tables, the native planner and its ctypes binding of
native/zstdtpu_core.cpp) is its own copy of the reference's, and nothing
here imports JAX or the ``zstdsharp_tpu`` package.
Importing this package initialises no CUDA state and builds nothing: the
kernels are compiled with nvcc on first use (``_build.py``).
"""
