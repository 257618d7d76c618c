"""The benchmark of brotlig_tpu_torch, the PyTorch and CUDA Brotli-G codec.

`python3 blgbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json (at the checkout's root)
and prints one JSON line. Everything that belongs to one configuration,
traffic mix or per-layer metric sits in a file of its own, found by the
name BENCHMARK.json gives it: configs/<config>.json, traffic/<mix>.json,
metrics/<metric>.py (end-to-end and per-layer alike). data/ makes the inputs from the seed, reference/
is the plain decoder that judges encodes, roofline.py holds the card's
peaks and the byte counts, tracing.py reads the profiler.
"""
