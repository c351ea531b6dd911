"""Operations and bytes of the kernels the benchmark reads rooflines of,
one module per kernel, and the chip's published peaks (``peaks``)."""
