"""pcfa_tpu_torch — the PCFA attack framework in PyTorch, with CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `pcfa_tpu` (JAX/Flax/Pallas), which stays the reference: every
module here is held against its `pcfa_tpu` counterpart by the tests in
`tests/test_torch_*.py`. This package imports `torch` and numpy, and
PIL, cv2 or matplotlib only inside the functions that read, write or
plot images.

Layout (mirrors `pcfa_tpu`):
    ops/       warp and correlation primitives; hand-written CUDA kernels
               (`corr_lookup`, `small_conv`, `local_corr`, `segsum`)
               beside their plain versions
    csrc/      the kernels' CUDA C++ sources, built by `ops/_build.py`
    models/    RAFT, GMA and PWCNet as `nn.Module`s, the model registry,
               weight conversion and the reference checkpoints' reader
    attack/    PCFA engine, L-BFGS with a leading pair axis, I-FGSM, the
               universal perturbation, losses, targets, box constraints
    io/        flow files (.flo, KITTI .png, .npy, .pfm)
    metrics/   flow error measures (AAE, EE, AEE, BP, Fl)
    viz/       flow color plots, error maps, quick views, `flow_show`
    data/      Sintel / KITTI / synthetic datasets and the batch loader
    parallel/  `multihost.process_shard`
    utils/     input padding, experiment tracking and artifacts, profiling
    cli/       `python -m pcfa_tpu_torch.cli.{attack_pcfa,attack_fgsm,
               evaluate_pcfa}`
    runtime.py `load_model` (checkpoint or random weights) / `make_flow_fn`
    config.py  dataset paths and environment knobs shared with `pcfa_tpu`

Entry points run on `device="cuda"` unless the caller passes
`device="cpu"`; there is no silent CPU fallback.
"""
