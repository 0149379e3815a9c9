"""POAS on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

``core`` holds the POAS planning stack (numpy, byte-identical to the
reference) and the heterogeneous GEMM executor; ``kernels`` holds the
hand-written CUDA kernels it runs on the card.
"""
