"""API layer, in a cell where the host paces decode and its clock
drifts: decode_gbps as decode_gbps.py reads it, reported per layer."""
from blgbench.harness import metric_reader

read = metric_reader("decode_gbps")
