"""Frozen arithmetic of the benchmark: kernels' and models' operations and
bytes, and the chip's peaks (``peaks.json``)."""
