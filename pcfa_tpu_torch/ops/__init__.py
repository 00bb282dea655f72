"""Differentiable primitives of the RAFT path and their CUDA kernels:
`warp` (coords grid, pooling, bilinear sampling), `correlation` (pyramid
and window lookup), `corr_lookup` and `small_conv` (kernel wrappers with
their plain versions), `_build` (nvcc build and ctypes loading)."""
