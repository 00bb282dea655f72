"""Differentiable primitives of the flow networks and their CUDA kernels:
`warp` (coords grid, pooling, bilinear sampling, the packed-corner
`grid_sample` and FlowNet2's `resample2d`, resizing), `channelnorm`,
`correlation` (RAFT's pyramid and window lookup, the plain patch
correlations), `corr_lookup`, `small_conv`, `local_corr` and `segsum`
(kernel wrappers with their plain versions), `lbfgs_hist` (the L-BFGS
history's compact-direction passes: kernels and plain versions), `_build`
(nvcc build and ctypes loading)."""
