"""The port's scalar Brotli-G codec (its copy of brotlig_tpu/refimpl/):
the page encoder that preconditioned textures take on the "native"
encode backend, its stream codec, and the scalar page decoder that the
tests use as an oracle. The page parse runs as a CUDA kernel on the card
(ops/ref_parse_kernel.py); the serializer is host Python, as in the JAX
package."""
