"""brotlig_tpu_torch: the PyTorch/CUDA port of the brotlig_tpu Brotli-G
codec, beside the JAX package (which stays the reference).

It covers decode: batched page decode on the fused and the two-phase
routes, pipelined over CUDA streams, BCn texture post-processing on the
device, and pooled decode of many archives (parallel/); and encode at the
greedy tier: device match finding with the native packer ("hybrid") or
with the device serializer ("full"), BCn preconditioning on the device,
and `python -m brotlig_tpu_torch.cli`. The port imports
nothing of brotlig_tpu: format/ and native/ are its own copies of the
format definitions and of the host C++ (stager, CPU decoder, encoder). The kernels under csrc/ are built with nvcc, and the
host C++ with g++, on first use.
"""
from .api import decode, decompressed_size, encode, max_compressed_size

__all__ = ["encode", "decode", "decompressed_size", "max_compressed_size"]
__version__ = "0.1.0"
