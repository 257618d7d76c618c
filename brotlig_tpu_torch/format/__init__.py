"""The port's own copy of the Brotli-G format definitions it reads:
constants, the error model, container headers and the precondition
geometry (from brotlig_tpu/format/, which the port does not import)."""
