"""Decode kernels in a cell that reports the card's time a GB:
decode_kernels_roofline as decode_kernels_roofline.py reads it."""
from blgbench.harness import metric_reader

read = metric_reader("decode_kernels_roofline")
