"""brotlig_tpu_torch: the PyTorch/CUDA port of the brotlig_tpu Brotli-G
codec, beside the JAX package (which stays the reference).

It covers decode: batched page decode on the fused and the two-phase
routes, pipelined over CUDA streams, BCn texture post-processing on the
device, pooled decode of many archives, one stream's pages split over
several devices and the gathers across processes (parallel/), and the
native host decoder (decode_cpu); and encode: device match finding with
the native packer ("hybrid") or with the device serializer ("full", the
greedy q1 tier or the windowed-DP q11 tier), BCn preconditioning on the
device, the preconditioned host encode of the scalar page coder
(refimpl/: its parse on the device, its serializer on the host), and
`python -m brotlig_tpu_torch.cli`. entry.py and tools/ are its entry
point and stage profiles. The port imports nothing of brotlig_tpu:
format/, refimpl/ and native/ are its own copies of the format
definitions, the scalar codec and the host C++ (stager, CPU decoder,
encoder). The
kernels under csrc/ are built with nvcc, and the host C++ with g++, on
first use.
"""
from .api import (decode, decode_cpu, decompressed_size, encode,
                  max_compressed_size)

__all__ = ["encode", "decode", "decode_cpu", "decompressed_size",
           "max_compressed_size"]
__version__ = "0.1.0"
