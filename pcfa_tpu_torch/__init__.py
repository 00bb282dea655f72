"""pcfa_tpu_torch — the PCFA attack framework in PyTorch, with CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `pcfa_tpu` (JAX/Flax/Pallas), which stays the reference: every
module here is held against its `pcfa_tpu` counterpart by the tests in
`tests/test_torch_*.py`. This package imports `torch` and numpy only.

Layout (mirrors `pcfa_tpu`):
    ops/       warp and correlation primitives; hand-written CUDA kernels
               (`corr_lookup`, `small_conv`) beside their plain versions
    csrc/      the kernels' CUDA C++ sources, built by `ops/_build.py`
    models/    RAFT as `nn.Module`s, the model registry, weight conversion
    attack/    PCFA engine, L-BFGS with a leading pair axis, losses,
               targets, box constraints
    utils/     input padding
    runtime.py `load_model` / `make_flow_fn`
    config.py  environment knobs shared with `pcfa_tpu`

Entry points run on `device="cuda"` unless the caller passes
`device="cpu"`; there is no silent CPU fallback.
"""
