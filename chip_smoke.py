#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pcfa_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from
`pcfa_tpu_torch/csrc/` itself (nvcc, sm_90a, one process per source, all
at once) and needs one card. Phases, each of which raises on failure (the
script then exits non-zero):

1. build: toolchain, build time, the card's name and power limit;
2. kernels: every kernel of the RAFT, RAFT-small, SpyNet, PWCNet and
   FlowNet2 PCFA paths against its plain PyTorch version on the card, at
   each main path's shapes (the lookup at radius 4 and at RAFT-small's 3;
   the small conv at RAFT's, at all of PWCNet's, with PWCNet's leaky
   epilogue and its derivative fused into dx, at SpyNet's 30 7×7 stride-1
   convs, bf16, with their sums per forward, float32 at the finest level,
   and at FlowNet2's 22 distinct shapes of its 41 per forward, bf16, with
   their sums, float32 at the k5 stride-2 shape and one transposed conv;
   FlowNet2's transposed convs run as one 3×3 conv with the combined
   weight and are also held against `F.conv_transpose2d`), in
   float32 and bf16 (the small conv's bf16 is its tensor-core kernel,
   float32 its CUDA-core route), with kernel, plain-version and
   library-call times and the bound (plus the patch correlation at
   FlowNetC's shape, and the warp's backward at FlowNet2's full-resolution
   border warp of 3-channel images). The warp's backward is one kernel for
   d img, d ix and d iy (PWCNet's four warps, a collision case, and
   SpyNet's six zero-padded warps of 3-channel images with the grid
   clipped to [−1, 1]). The lookup's backward adds into
   buffers the caller owns: it is held against the plain accumulating
   backward over 4 launches, and a `corr_lookup_closure` row checks and
   times what one RAFT closure does with the lookup (the pyramid, 12
   lookups, their backward through autograd). The compact L-BFGS
   direction's two passes over the history (`ops/lbfgs_hist.py`) are held
   at each main path's shape and history dtype with a full ring (RAFT's
   for 2 and 16 pairs, SpyNet's, FlowNet2's, PWCNet's float32), and every
   main path must launch both once per L-BFGS iteration. Each row says how its
   kernel and library times were taken: `loop` (10 launches back to back)
   or `graph` (a CUDA-graph replay: device time, warm L2, the loop time
   beside it),
   which every kernel row of the lookup, PWCNet's convs, the patch
   correlation and the warp's backward uses;
3. parity: a random-init RAFT (seed 0, flow-head conv2 damped ×0.01),
   128×128, 3 iterations, and a random-init PWCNet (seed 0), 128×128, 2
   pairs, both float32, on the CPU (plain versions) and on the card
   (kernels): flows and input gradients. The same for GMA (gamma 0.5),
   RAFT-small (damped, 3 iterations), SpyNet (6 levels) and FlowNet2 (1
   pair; SpyNet's and FlowNet2's gradients against the CPU's float64 as
   well), and for RAFT
   with `corr_impl='fused'` (blocks of 100 queries: the last one short),
   with 'hybrid', and with `remat=True`, which must also agree with the
   card's run without remat;
4. main path, RAFT: the disjoint PCFA attack on full RAFT (12 iterations)
   at the KITTI shape (375×1242 padded to 376×1248), 2 random pairs at
   once, bf16 network and bf16 compact L-BFGS history, δ-bound 0.005, zero
   target, AEE, clipping, history 100; steps 2 × max_iter 2 so the run
   stays short;
5. main paths, GMA, RAFT-small and SpyNet: the same attack on full GMA (6
   iterations), RAFT-small (12 iterations, 376×1248) and SpyNet (6
   levels, 375×1242 padded to ÷64, 384×1280), each at 2 pairs in RAFT's
   environment;
6. main paths, PWCNet and FlowNet2: the same attack on full PWCNet at
   375×1242 padded to ÷64 (384×1280), 1 pair, bf16 network and a float32
   L-BFGS history (PWCNet refuses a bf16 one), in an environment of its
   own; then on full FlowNet2 (random weights from seed 0, 162.5 M
   parameters), 384×1280, 1 pair, bf16 network and a bf16 history;
7. corr paths: one forward+backward closure of RAFT (12 iterations, bf16)
   at 2× KITTI (750×2484 padded to 752×2488), 2 pairs, where 'auto' must
   resolve to 'fused'; then 'hybrid' and 'materialized' (forced by the
   budget knob): closure times, peak memory, agreeing flows;
8. checkpoint: a RAFT file and a RAFT-small file in the reference's
   shipped layout and a SpyNet directory of per-layer files, written with
   `torch.save`, and a FlowNet2 file (`{'state_dict': …}`, ≈ 650 MB),
   loaded by `load_model(checkpoint=...)` on the card, and one forward of
   each held against the same checkpoint loaded on the CPU;
9. other attacks: I-FGSM (2 steps) and the universal attack (2 batches ×
   1 step × max_iter 2, the L-BFGS state carried) on full SpyNet at
   384×1280, 2 pairs, in SpyNet's environment: finite metrics, the
   history grown across the batches, the small conv and the warp's
   backward launched;
10. the CLIs as a user runs them (`phase_clis`);
11. slice J on two ranks of the one card, gloo (`phase_ranks`): this
    process first computes float32 references; then two processes
    (`python3 chip_smoke.py --rank <folder>`, MASTER_ADDR etc. set) each
    run J.1, RAFT's pair-parallel attack (`pcfa_attack_dp`, one KITTI
    pair per rank, 2 steps × max_iter 2, bf16) and its float32 first
    closure against this process's run of the pair; J.2, SpyNet's
    universal attack over the ranks (2 batches × 1 step × max_iter 2,
    one pair per rank, bf16; δ bit-identical over the ranks) and its
    float32 first closure; J.3, one float32 closure of RAFT-12 at
    752×2488 (materialized) and of GMA-6 at 384×1248 split by rows,
    against the unsplit closures (flow rtol/atol 1e-4, gradients 1e-3 /
    1e-6), each rank's peak against the unsplit one. A rank that fails
    or runs past 600 s fails the phase.
Every kernel of a path must be launched during that path's run (the
counts are set to 0 just before it and read just after); each main path
also prints its kernels' launches in one closure. Before each main
path it times 2,000 tiny launches: the host's launch cost, which sets the
pace of a host-bound step.

It prints a `{"kernels": [...]}` line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`. Without CUDA it exits non-zero and
prints no result. `--profile` adds a `torch.profiler` table of one outer
step of each main path (device busy share, device launches, top kernels
by device time) and the device time and launches of one closure.
`compare_warp()` and `compare_lookup()` time the warp's and the lookup's
rows in a form any tree of the port runs (parent-vs-change comparisons);
so do the main paths, one at a time: `phase_main_path(net, pairs)` inside
`main_path_env(net)`. `phase_corr_paths()` runs phase 7 alone.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core rate
              torch.float32: 67e12}     # float32 outside the tensor cores
KITTI_HW = (375, 1242)
PAIRS = 2
R = 4
R_SMALL = 3    # RAFT-small's lookup radius

PWC_PAIRS = 1
# PWCNet's correlation levels at 384×1280: (name, H, W, C)
PWC_LEVELS = [("L6", 6, 20, 196), ("L5", 12, 40, 128), ("L4", 24, 80, 96),
              ("L3", 48, 160, 64), ("L2", 96, 320, 32)]
# PWCNet's small convs at 384×1280, all k3 with the leaky epilogue: the
# pyramid runs both images of the pair at once, the context net one flow.
# (layers of this shape, B, C_in, H, W, C_out, stride)
PWC_CONVS = [("conv1a", 2, 3, 384, 1280, 16, 2),
             ("conv1aa,conv1b", 2, 16, 192, 640, 16, 1),
             ("conv2a", 2, 16, 192, 640, 32, 2),
             ("conv2aa,conv2b", 2, 32, 96, 320, 32, 1),
             ("conv3a", 2, 32, 96, 320, 64, 2),
             ("conv3aa,conv3b", 2, 64, 48, 160, 64, 1),
             ("conv4a", 2, 64, 48, 160, 96, 2),
             ("dc_conv6", 1, 64, 96, 320, 32, 1)]

# (name, module, wrapper, source, TPU kernel it replaces)
KERNELS = [
    ("corr_lookup_fwd", "corr_lookup", "corr_window_fwd",
     "pcfa_tpu_torch/csrc/corr_lookup.cu",
     "pcfa_tpu/ops/pallas/corr_lookup.py:123"),
    ("corr_lookup_bwd", "corr_lookup", "corr_window_bwd",
     "pcfa_tpu_torch/csrc/corr_lookup.cu",
     "pcfa_tpu/ops/pallas/corr_lookup.py:160"),
    ("small_conv_fwd", "small_conv", "small_conv_fwd",
     "pcfa_tpu_torch/csrc/small_conv.cu",
     "pcfa_tpu/ops/pallas/small_conv.py:170"),
    ("small_conv_dx", "small_conv", "small_conv_dx",
     "pcfa_tpu_torch/csrc/small_conv.cu",
     "pcfa_tpu/ops/pallas/small_conv.py:350"),
    ("local_corr_fwd", "local_corr", "local_corr_fwd",
     "pcfa_tpu_torch/csrc/local_corr.cu",
     "pcfa_tpu/ops/pallas/local_corr.py:334"),
    ("local_corr_bwd", "local_corr", "local_corr_bwd",
     "pcfa_tpu_torch/csrc/local_corr.cu",
     "pcfa_tpu/ops/pallas/local_corr.py:199"),
    ("warp_bwd", "segsum", "warp_bwd_cuda",
     "pcfa_tpu_torch/csrc/segsum.cu",
     "pcfa_tpu/ops/pallas/segsum.py:170"),
]
# FlowNet2's 41 small-conv launches per forward at 384×1280 (1 pair), by
# distinct shape: (layers, launches per forward, C_in, H, W, C_out, k,
# stride, act) of a conv; for a transposed conv (k 4, stride 2, run as
# one 3×3 conv with 4·C_out outputs and a depth-to-space), k is 4
FN2_CONVS = [
    ("C conv1 (both images)", 2, 3, 384, 1280, 64, 7, 2, "leaky"),
    ("C conv2 x2, S1/S2 conv2", 4, 64, 192, 640, 128, 5, 2, "leaky"),
    ("S1/S2 conv1", 2, 12, 384, 1280, 64, 7, 2, "leaky"),
    ("SD conv0", 1, 6, 384, 1280, 64, 3, 1, "leaky"),
    ("SD/Fusion conv1", 2, 64, 384, 1280, 64, 3, 2, "leaky"),
    ("SD/Fusion conv1_1", 2, 64, 192, 640, 128, 3, 1, "leaky"),
    ("Fusion conv0", 1, 11, 384, 1280, 64, 3, 1, "leaky"),
    ("SD predict_flow3", 1, 128, 48, 160, 2, 3, 1, None),
    ("SD predict_flow2", 1, 64, 96, 320, 2, 3, 1, None),
    ("Fusion predict_flow2", 1, 128, 96, 320, 2, 3, 1, None),
    ("Fusion inter_conv1", 1, 162, 192, 640, 32, 3, 1, None),
    ("Fusion predict_flow1", 1, 32, 192, 640, 2, 3, 1, None),
    ("Fusion inter_conv0", 1, 82, 384, 1280, 16, 3, 1, None),
    ("Fusion predict_flow0", 1, 16, 384, 1280, 2, 3, 1, None),
    ("C/S1/S2/SD upsampled_flow6_to_5", 4, 2, 6, 20, 2, 4, 2, None),
    ("C/S1/S2/SD upsampled_flow5_to_4", 4, 2, 12, 40, 2, 4, 2, None),
    ("C/S1/S2/SD upsampled_flow4_to_3", 4, 2, 24, 80, 2, 4, 2, None),
    ("C/S1/S2/SD upsampled_flow3_to_2", 4, 2, 48, 160, 2, 4, 2, None),
    ("Fusion upsampled_flow2_to_1", 1, 2, 96, 320, 2, 4, 2, None),
    ("Fusion upsampled_flow1_to_0", 1, 2, 192, 640, 2, 4, 2, None),
    ("Fusion deconv1", 1, 128, 96, 320, 32, 4, 2, "leaky"),
    ("Fusion deconv0", 1, 162, 192, 640, 16, 4, 2, "leaky"),
]
FN2_PAIRS = 1

# the kernels each main path must launch
PATH_KERNELS = {
    "RAFT": ["corr_lookup_fwd", "corr_lookup_bwd", "small_conv_fwd",
             "small_conv_dx"],
    "GMA": ["corr_lookup_fwd", "corr_lookup_bwd", "small_conv_fwd",
            "small_conv_dx"],
    "PWCNet": ["local_corr_fwd", "local_corr_bwd", "warp_bwd",
               "small_conv_fwd", "small_conv_dx"],
    "RAFT-small": ["corr_lookup_fwd", "corr_lookup_bwd"],
    "SpyNet": ["small_conv_fwd", "small_conv_dx", "warp_bwd"],
    "FlowNet2": ["small_conv_fwd", "small_conv_dx", "local_corr_fwd",
                 "local_corr_bwd", "warp_bwd"],
}
# GMA runs RAFT's encoders and lookup at RAFT's shapes: its kernel rows
# are RAFT's
ROW_PATH = {"GMA": "RAFT"}

# SpyNet at 384×1280: the six pyramid levels, coarsest first, and the five
# 7×7 stride-1 convs of each level's block, (C_in, C_out, act)
SPY_LEVELS = [(384 >> i, 1280 >> i) for i in range(5, -1, -1)]
SPY_CONVS = [(8, 32, "relu"), (32, 64, "relu"), (64, 32, "relu"),
             (32, 16, "relu"), (16, 2, None)]


def wrapper(name: str):
    """The launching wrapper of kernel `name` (it carries `.launches`)."""
    import importlib

    _, mod, attr, _, _ = next(k for k in KERNELS if k[0] == name)
    return getattr(importlib.import_module(f"pcfa_tpu_torch.ops.{mod}"),
                   attr)


def hist_wrappers() -> dict:
    """{name: launching wrapper} of the compact L-BFGS direction's kernels
    (`ops/lbfgs_hist.py`), which every main path launches once each per
    iteration. They replace no TPU kernel (the JAX package leaves the
    products to XLA), so `KERNELS` and its summary line leave them out;
    `kernels_lbfgs_hist` prints their rows."""
    from pcfa_tpu_torch.ops import lbfgs_hist as lh

    return {"lbfgs_hist_products": lh.hist_products_cuda,
            "lbfgs_hist_combine": lh.hist_combine_cuda}


@contextlib.contextmanager
def restored_env():
    """Whatever a phase sets in os.environ is undone when it ends."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


@contextlib.contextmanager
def main_path_env(net: str):
    """The environment of `net`'s main path: bf16 network and compact
    L-BFGS; a bf16 history, except for PWCNet (it refuses one: float32)."""
    with restored_env():
        os.environ["PCFA_COMPUTE_DTYPE"] = "bfloat16"
        os.environ["PCFA_LBFGS_DIRECTION"] = "compact"
        if net == "PWCNet":
            os.environ.pop("PCFA_LBFGS_DTYPE", None)
        else:
            os.environ["PCFA_LBFGS_DTYPE"] = "bfloat16"
        yield


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call of `fn` from replays of a CUDA graph of `reps`
    calls: no host launch cost between the kernels. The inputs stay in
    the 50 MB L2 across calls where they fit (PWCNet's maps do), so these
    are warm-cache times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


def check_close(what: str, got, ref, tol: float) -> float:
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs().nan_to_num(nan=float("inf"))
    err = float(diff.max())
    # relative to the plain result's own largest magnitude, with no floor:
    # a limit stays relative to values well under 1
    scale = float(ref.abs().max()) or 1.0
    if err > tol * scale:
        at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
        raise AssertionError(f"{what}: max abs err {err} > {tol} × {scale} "
                             f"at {at}: kernel {float(got[at])}, plain "
                             f"{float(ref[at])}")
    return err


# ------------------------------------------------------------------ 1 ---

def phase_build():
    from pcfa_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    log(f"# toolchain: torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, nvcc: {release[0] if release else '?'}")
    t0 = time.perf_counter()
    times = _build.build()
    log(f"# build: {json.dumps({k: round(v, 1) for k, v in times.items()})} "
        f"s per library (parallel), {time.perf_counter() - t0:.1f} s wall")
    log(f"# card: {card_line()}")


# ------------------------------------------------------------------ 2 ---

def kitti_lookup_inputs(dtype, gen):
    """The KITTI pyramid for B = 2 pairs: N = 2·47·156 queries, levels
    47×156, 23×78, 11×39, 5×19; coords = the pixel grid plus a random flow
    of a few pixels, some queries pushed far out of the map."""
    h1, w1 = 47, 156
    n = PAIRS * h1 * w1
    shapes = [(47, 156), (23, 78), (11, 39), (5, 19)]
    levels = [torch.randn((n, h, w), generator=gen).to("cuda", dtype)
              for h, w in shapes]
    y, x = torch.meshgrid(torch.arange(h1), torch.arange(w1), indexing="ij")
    grid = torch.stack([x, y], -1).float().reshape(1, -1, 2).expand(PAIRS, -1,
                                                                    -1)
    coords = grid.reshape(n, 2) + 3.0 * torch.randn((n, 2), generator=gen)
    coords[::97] += 400.0
    return levels, coords.contiguous().to("cuda")


def lookup_patch_cells(levels, coords, r: int = R) -> int:
    """In-map cells of every query's (2r+2)² patch, all levels: what the
    lookup must read for this run's coords."""
    total = 0
    for i, lv in enumerate(levels):
        h, w = lv.shape[1:]
        c = coords / 2 ** i
        x0 = torch.floor(c[:, 0]) - r
        y0 = torch.floor(c[:, 1]) - r
        side = 2 * r + 2
        nx = (torch.clamp(x0 + side, 0, w) - torch.clamp(x0, 0, w)).clamp(min=0)
        ny = (torch.clamp(y0 + side, 0, h) - torch.clamp(y0, 0, h)).clamp(min=0)
        total += int((nx * ny).sum())
    return total


def grid_sample_lookup(levels, coords, r: int = R):
    """The library call: one `F.grid_sample` per level (the reference
    RAFT's CorrBlock form), used here as a yardstick only."""
    p = 2 * r + 1
    lin = torch.linspace(-r, r, p, device=coords.device)
    da, db = torch.meshgrid(lin, lin, indexing="ij")
    delta = torch.stack([da, db], -1)
    grids = []
    for i, lv in enumerate(levels):
        h, w = lv.shape[1:]
        pts = coords[:, None, None] / 2 ** i + delta[None]
        grids.append(torch.stack([2 * pts[..., 0] / (w - 1) - 1,
                                  2 * pts[..., 1] / (h - 1) - 1], -1))
    return grids


def row_adder(rows: list):
    """A function that appends one kernel row to `rows` and prints it.
    `path` is the main path whose shape the row has (None: a shape no
    main path gives, such as a stress case)."""
    card = card_line()

    def row(name, dtype, shape, err, ms, plain, lib, nbytes, flops, path,
            timed="loop", loop_ms=None):
        b, by = bound_ms(nbytes, flops, dtype)
        rows.append(dict(name=name, dtype=str(dtype).split(".")[-1],
                         shape=shape, path=path, max_abs_err=err, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b,
                         bound_by=by, nbytes=nbytes, flops=flops,
                         timed=timed))
        lib_s = "none" if lib is None else f"{lib:.4f} ms"
        loop_s = "" if loop_ms is None else f" (loop {loop_ms:.4f} ms)"
        log(f"  {name:16s} {rows[-1]['dtype']:8s} {shape:34s} err {err:.3g}"
            f"  kernel {ms:.4f} ms{loop_s}  plain {plain:.4f} ms  library "
            f"{lib_s}  bound {b:.4f} ms ({by})  timed: {timed}  [{card}]")

    return row


def phase_kernels():
    rows = []
    kernels_raft(rows)
    kernels_pwc_conv(rows)
    kernels_spynet_conv(rows)
    kernels_flownet2_conv(rows)
    kernels_local_corr(rows)
    kernels_warp_bwd(rows)
    kernels_lbfgs_hist(rows)
    torch.cuda.empty_cache()
    return rows


def kernels_raft(rows):
    gen = torch.Generator().manual_seed(0)
    row = row_adder(rows)

    # tolerances relative to the values' scale: float32 convs differ from
    # cuDNN (TF32 off) by summation order; the plain lookup's grid_sample
    # moves sample positions by ~1e-5 px at x ≈ 150 (normalize/unnormalize
    # round trip); bf16 outputs differ by bf16 rounding
    log("# kernels vs plain (main-path shapes; tolerances: float32 1e-4, "
        "bf16 3e-2, relative to the values' scale)")
    for dtype, tol_l, tol_c in ((torch.float32, 1e-4, 1e-4),
                                (torch.bfloat16, 3e-2, 3e-2)):
        lookup_rows(row, gen, dtype, tol_l)
        lookup_rows(row, gen, dtype, tol_l, R_SMALL, "RAFT-small")
        lookup_closure(gen, dtype, tol_l)
        for tag, (B, c_in, h, w, c_out, k, s) in (
                ("stem k7 s2 3->64", (4, 3, 376, 1248, 64, 7, 2)),
                ("layer1 k3 s1 64->64", (4, 64, 188, 624, 64, 3, 1))):
            conv_rows(row, gen, dtype, tol_c, tag, "RAFT",
                      (B, c_in, h, w, c_out, k, s), None)


def lookup_rows(row, gen, dtype, tol, r: int = R, path: str = "RAFT"):
    """The lookup's forward and its accumulating backward at RAFT's shape
    (RAFT-small's is the same, at radius 3). The backward adds into
    buffers the caller owns: 4 launches with different coords into one
    zeroed set are held against the plain accumulating backward (each
    launch's gradient rounded to the maps' dtype and added), then one
    launch is timed. Its bound counts the cotangent read and the in-map
    patch cells read and written."""
    from pcfa_tpu_torch.ops import corr_lookup as cl

    isz = torch.empty((), dtype=dtype).element_size()
    levels, coords = kitti_lookup_inputs(dtype, gen)
    n = coords.shape[0]
    shape = f"N={n} L=4 r={r} (47x156..5x19)"
    out = cl.corr_window_fwd(levels, coords, r)
    torch.cuda.synchronize()
    err = check_close(f"corr lookup fwd r={r}", out,
                      cl.corr_window_plain(levels, coords, r), tol)
    # grid_sample needs its grid in the map's dtype: a bf16 grid rounds
    # pixel positions, so in bf16 it is a timing yardstick only
    grids = [gr.to(dtype) for gr in grid_sample_lookup(levels, coords, r)]
    lib = graph_ms(lambda: [F.grid_sample(
        lv[:, None], g, mode="bilinear", padding_mode="zeros",
        align_corners=True) for lv, g in zip(levels, grids)])
    cells = lookup_patch_cells(levels, coords, r)
    fwd = lambda: cl.corr_window_fwd(levels, coords, r)  # noqa: E731
    row("corr_lookup_fwd", dtype, shape, err, graph_ms(fwd),
        cuda_ms(lambda: cl.corr_window_plain(levels, coords, r)), lib,
        cells * isz + coords.numel() * 4 + out.numel() * isz,
        3 * 3 * out.numel(), path, "graph", cuda_ms(fwd))

    g = torch.randn(out.shape, generator=gen).to("cuda", dtype)
    got = [torch.zeros_like(t) for t in levels]
    ref = [torch.zeros_like(t) for t in levels]
    for i in range(4):
        c = coords + 2.0 * i
        cl.corr_window_bwd(g, got, c, r)
        cl.corr_window_bwd_acc_plain(g, ref, c, r)
    torch.cuda.synchronize()
    err = max(check_close(f"corr lookup bwd r={r} (4 launches)", a, b, tol)
              for a, b in zip(got, ref))
    p = 2 * r + 1
    gs = [g[:, i * p * p:(i + 1) * p * p].reshape(n, 1, p, p)
          for i in range(len(levels))]
    lib = graph_ms(lambda: [torch.ops.aten.grid_sampler_2d_backward(
        gl, lv[:, None], gr, 0, 0, True, [True, False])
        for gl, lv, gr in zip(gs, levels, grids)], reps=5)
    bwd = lambda: cl.corr_window_bwd(g, got, coords, r)  # noqa: E731
    row("corr_lookup_bwd", dtype, shape, err, graph_ms(bwd),
        cuda_ms(lambda: cl.corr_window_bwd_acc_plain(g, ref, coords, r),
                reps=5), lib,
        g.numel() * isz + coords.numel() * 4 + 2 * cells * isz,
        4 * 3 * cells, path, "graph", cuda_ms(bwd))


def closure_inputs(gen, dtype, iters=12):
    """RAFT's feature maps for B pairs at 376×1248 (47×156×256, requiring
    grad), `iters` coords (the pixel grid plus a random flow of a few
    pixels) and cotangents of the lookup's output."""
    f1, f2 = (torch.randn((PAIRS, 47, 156, 256), generator=gen)
              .to("cuda", dtype).requires_grad_() for _ in range(2))
    y, x = torch.meshgrid(torch.arange(47), torch.arange(156), indexing="ij")
    grid = torch.stack([x, y], -1).float()
    cs = [(grid + 3.0 * torch.randn((PAIRS, 47, 156, 2), generator=gen))
          .to("cuda") for _ in range(iters)]
    gs = [torch.randn((PAIRS, 47, 156, 4 * (2 * R + 1) ** 2),
                      generator=gen).to("cuda", dtype) for _ in range(iters)]
    return f1, f2, cs, gs


def closure_grads(f1, f2, cs, gs, lookup):
    """One closure's lookups as RAFT runs them: the pooled pyramid of f1
    and f2, `lookup` at each coords, and the backward of every output
    (with its cotangent) to f1 and f2."""
    from pcfa_tpu_torch.ops.correlation import corr_pyramid_pooled

    pyr = corr_pyramid_pooled(f1, f2, 4)
    outs = [lookup(pyr, c, R) for c in cs]
    return torch.autograd.grad(outs, (f1, f2), gs)


def closure_ms(gen, dtype) -> tuple[float, float]:
    """Time of one `closure_grads` through `corr_lookup_window`: the
    pyramid products, 12 lookups and their backward. Returns (device
    time by replaying a CUDA graph of 3 closures, time between CUDA
    events over 5 closures issued from Python, which the host's pace
    sets when it is the slower side). It calls only `corr_pyramid_pooled`
    and `corr_lookup_window`, so it times any tree of the port alike."""
    from pcfa_tpu_torch.ops.correlation import corr_lookup_window

    inputs = closure_inputs(gen, dtype)
    closure = lambda: closure_grads(*inputs, corr_lookup_window)  # noqa
    return graph_ms(closure, reps=3), cuda_ms(closure, reps=5)


def lookup_closure(gen, dtype, tol):
    """The `corr_lookup_closure` row: f1's and f2's gradients through the
    kernels against the same closure through the plain lookup (autograd
    sums its 12 dense gradients), then its device time."""
    from pcfa_tpu_torch.ops import corr_lookup as cl
    from pcfa_tpu_torch.ops.correlation import corr_lookup_window

    inputs = closure_inputs(gen, dtype)
    got = closure_grads(*inputs, corr_lookup_window)
    ref = closure_grads(*inputs, lambda p, c, r: cl.corr_window_plain(
        list(p), c.reshape(-1, 2), r).reshape(*c.shape[:3], -1))
    torch.cuda.synchronize()
    err = max(check_close(f"corr lookup closure {name}", a, b, tol)
              for name, a, b in zip(("d f1", "d f2"), got, ref))
    del got, ref, inputs
    dev, events = closure_ms(gen, dtype)
    log(f"  {'corr_lookup_closure':16s} {str(dtype)[6:]:8s} "
        f"{'B=2 47x156x256, 12 lookups':34s} err {err:.3g}  closure "
        f"(pyramid products, 12 lookups, backward) {dev:.4f} ms  timed: "
        f"graph (CUDA events from Python {events:.4f} ms)  [{card_line()}]")


def compare_lookup():
    """The lookup's rows in a form any tree of the port runs, for a
    parent-vs-change comparison in one call (copy this script into the
    other tree): graph-timed forward and one backward launch at RAFT's
    shape, and the closure's device time, float32 and bf16. Times only;
    `lookup_rows` and `lookup_closure` check the values."""
    from pcfa_tpu_torch.ops import corr_lookup as cl

    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        levels, coords = kitti_lookup_inputs(dtype, gen)
        g = torch.randn((coords.shape[0], 4 * (2 * R + 1) ** 2),
                        generator=gen).to("cuda", dtype)
        bufs = [torch.zeros_like(t) for t in levels]
        fwd = graph_ms(lambda: cl.corr_window_fwd(levels, coords, R))
        bwd = graph_ms(lambda: cl.corr_window_bwd(g, bufs, coords, R),
                       reps=5)
        del levels, g, bufs
        dev, events = closure_ms(gen, dtype)
        log(f"# compare lookup {str(dtype)[6:]}: fwd {fwd:.4f} ms, bwd "
            f"launch {bwd:.4f} ms, closure {dev:.4f} ms (graph-timed); "
            f"closure {events:.4f} ms (CUDA events from Python) "
            f"[{card_line()}]")
        torch.cuda.empty_cache()


def conv_rows(row, gen, dtype, tol, tag, path, conv, act, graph=False):
    """One small-conv shape: the forward kernel (with `act`) against
    `conv_plain`, and dx through the autograd path (the activation's
    derivative fused into the dx kernel, taken at the kernel's own output)
    against the plain dx of the same cotangent and output. Library calls:
    `F.conv2d` (without the epilogue) and `convolution_backward` (of the
    masked cotangent). Times: 10 launches back to back (`timed: loop`),
    or with `graph` a CUDA-graph replay (`timed: graph`: device time, the
    loop time beside it), for layers short enough that the loop runs at
    the host's launch pace."""
    from pcfa_tpu_torch.ops import small_conv as sc

    B, c_in, h, w, c_out, k, s = conv
    isz = torch.empty((), dtype=dtype).element_size()
    x = torch.randn((B, c_in, h, w), generator=gen).to("cuda", dtype)
    wt = (torch.randn((c_out, c_in, k, k), generator=gen)
          / math.sqrt(c_in * k * k)).to("cuda", dtype)
    bias = torch.randn(c_out, generator=gen).to("cuda", dtype)
    out = sc.small_conv_fwd(x, wt, bias, s, act)
    torch.cuda.synchronize()
    err = check_close(f"conv fwd {tag}", out, sc.conv_plain(
        x.float(), wt.float(), bias.float(), s, act), tol)
    flops = 2 * out.numel() * c_in * k * k
    io = (x.numel() + wt.numel() + bias.numel() + out.numel()) * isz
    shape = f"x={tuple(x.shape)} {tag}"

    def times(kernel, plain, library):
        if not graph:
            return dict(ms=cuda_ms(kernel), plain=cuda_ms(plain),
                        lib=cuda_ms(library))
        return dict(ms=graph_ms(kernel), plain=graph_ms(plain),
                    lib=graph_ms(library), timed="graph",
                    loop_ms=cuda_ms(kernel))

    row("small_conv_fwd", dtype, shape, err, nbytes=io, flops=flops,
        path=path, **times(
            lambda: sc.small_conv_fwd(x, wt, bias, s, act),
            lambda: sc.conv_plain(x, wt, bias, s, act),
            lambda: F.conv2d(x, wt, bias, s, k // 2)))

    gout = torch.randn(out.shape, generator=gen).to("cuda", dtype)
    xg = x.detach().requires_grad_(True)
    o = sc.small_conv2d(xg, wt, bias, s, act)
    o.backward(gout)
    torch.cuda.synchronize()
    od = o.detach() if act is not None else None
    err = check_close(f"conv dx {tag}", xg.grad, sc.conv_dx_plain(
        gout.float(), wt.float(), x.shape, s,
        None if od is None else od.float(), act), tol)
    gk = sc._act_grad(gout, od, act)
    row("small_conv_dx", dtype, shape, err,
        nbytes=(gout.numel() * (2 if act else 1) + wt.numel() + x.numel())
        * isz, flops=flops, path=path, **times(
            lambda: sc.small_conv_dx(gout, wt, x.shape, s, od, act),
            lambda: sc.conv_dx_plain(gout, wt, x.shape, s, od, act),
            lambda: torch.ops.aten.convolution_backward(
                gk, x, wt, None, [s, s], [k // 2, k // 2], [1, 1], False,
                [0, 0], 1, [True, False, False])))


def kernels_pwc_conv(rows):
    """The small conv at every one of PWCNet's 11 kernel-routed layers at
    384×1280 (k3, stride 1 or 2, leaky epilogue), float32 and bf16; prints
    each time summed over the 11 layers, as one closure runs them (each
    layer's forward and dx once)."""
    gen = torch.Generator().manual_seed(3)
    row = row_adder(rows)
    log("# small conv vs plain (PWCNet's layers at 384x1280, leaky)")
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        for layers, B, c_in, h, w, c_out, s in PWC_CONVS:
            conv_rows(row, gen, dtype, tol,
                      f"{layers} k3 s{s} {c_in}->{c_out}", "PWCNet",
                      (B, c_in, h, w, c_out, 3, s), "leaky", graph=True)
        # the rows just added: forward, dx for each shape in turn
        sums = {}
        for i, r in enumerate(rows[-2 * len(PWC_CONVS):]):
            n = len(PWC_CONVS[i // 2][0].split(","))
            acc = sums.setdefault(r["name"], dict.fromkeys(
                ("ms", "plain_ms", "library_ms", "bound_ms"), 0.0))
            for k in acc:
                acc[k] += n * r[k]
        slowest = max(rows[-2 * len(PWC_CONVS):], key=lambda r: r["ms"])
        log(f"# small conv, PWCNet's 11 layers per closure, {str(dtype)[6:]}"
            f" (graph-timed, warm L2): " + "; ".join(
                f"{name} kernel {a['ms']:.4f} ms, plain {a['plain_ms']:.4f}"
                f" ms, library {a['library_ms']:.4f} ms, bound "
                f"{a['bound_ms']:.4f} ms" for name, a in sums.items())
            + f"; slowest layer {slowest['name']} {slowest['shape']} "
            f"{slowest['ms']:.4f} ms [{card_line()}]")


def kernels_spynet_conv(rows):
    """The small conv at SpyNet's 30 convs per forward at 384×1280 (2
    pairs; 7×7 stride 1, ReLU on four of each level's five), bf16 (its
    main path's dtype), graph-timed, each against the plain version; then
    each time summed over the 30, as one forward runs them (and one
    closure's backward their dx). float32 (the CUDA-core route, which no
    main path runs) at the finest level's five, loop-timed. Bounds: the
    larger of bytes and bf16 tensor-core (or float32) operations, per
    row."""
    gen = torch.Generator().manual_seed(5)
    row = row_adder(rows)
    log("# small conv vs plain (SpyNet's 7x7 stride-1 convs at 384x1280, "
        "2 pairs)")
    for dtype, tol, levels in ((torch.bfloat16, 3e-2, SPY_LEVELS),
                               (torch.float32, 1e-4, SPY_LEVELS[-1:])):
        n0 = len(rows)
        for h, w in levels:
            for c_in, c_out, act in SPY_CONVS:
                conv_rows(row, gen, dtype, tol,
                          f"k7 s1 {c_in}->{c_out} {act or 'none'}", "SpyNet",
                          (PAIRS, c_in, h, w, c_out, 7, 1), act,
                          graph=dtype == torch.bfloat16)
            torch.cuda.empty_cache()
        sums = {}
        for r in rows[n0:]:
            acc = sums.setdefault(r["name"], dict.fromkeys(
                ("ms", "plain_ms", "library_ms", "bound_ms"), 0.0))
            for k in acc:
                acc[k] += r[k]
        timed = "graph" if dtype == torch.bfloat16 else "loop"
        log(f"# small conv, SpyNet's {len(rows[n0:]) // 2} convs per forward"
            f", {str(dtype)[6:]} ({timed}-timed): " + "; ".join(
                f"{name} kernel {a['ms']:.4f} ms, plain {a['plain_ms']:.4f}"
                f" ms, library {a['library_ms']:.4f} ms, bound "
                f"{a['bound_ms']:.4f} ms" for name, a in sums.items())
            + f" [{card_line()}]")


def deconv_rows(row, gen, dtype, tol, tag, path, conv, act):
    """One of FlowNet2's transposed convs (k 4, stride 2, padding 1) as the
    port runs it: one stride-1 3×3 small-conv launch with the combined
    weight (`models/flownet2.combined_deconv_weight`, 4·C_out outputs),
    then `pixel_shuffle`. Forward and dx (the leaky derivative fused) are
    held against the plain versions of that 3×3 conv, and the shuffled
    output and the input gradient against `F.conv_transpose2d`'s in
    float32. Library calls: `F.conv_transpose2d` (the row's library_ms)
    and `F.conv2d` of the combined weight, both without the
    epilogue, and their input gradients by `convolution_backward` (the
    latter two printed beside the rows). Bound:
    the transposed conv's own products (4 taps per output) and bytes.
    Graph-timed."""
    from pcfa_tpu_torch.models.flownet2 import combined_deconv_weight
    from pcfa_tpu_torch.ops import small_conv as sc

    B, c_in, h, w, co = conv
    isz = torch.empty((), dtype=dtype).element_size()
    x = torch.randn((B, c_in, h, w), generator=gen).to("cuda", dtype)
    wt = (torch.randn((c_in, co, 4, 4), generator=gen)
          / math.sqrt(16 * c_in)).to("cuda", dtype)
    bias = torch.randn(co, generator=gen).to("cuda", dtype)
    w3, b4 = combined_deconv_weight(wt, bias)
    out = sc.small_conv_fwd(x, w3, b4, 1, act)
    torch.cuda.synchronize()
    err = check_close(f"deconv fwd {tag}", out, sc.conv_plain(
        x.float(), w3.float(), b4.float(), 1, act), tol)
    lib_out = sc._apply_act(F.conv_transpose2d(
        x.float(), wt.float(), bias.float(), 2, 1), act)
    check_close(f"deconv {tag} vs conv_transpose2d", F.pixel_shuffle(
        out, 2), lib_out, tol)
    flops = 2 * B * co * 4 * h * w * c_in * 4
    shape = f"x={tuple(x.shape)} {tag}"
    row("small_conv_fwd", dtype, shape, err,
        graph_ms(lambda: sc.small_conv_fwd(x, w3, b4, 1, act)),
        graph_ms(lambda: sc.conv_plain(x, w3, b4, 1, act)),
        graph_ms(lambda: F.conv_transpose2d(x, wt, bias, 2, 1)),
        (x.numel() + wt.numel() + co + out.numel()) * isz, flops, path,
        "graph", cuda_ms(lambda: sc.small_conv_fwd(x, w3, b4, 1, act)))
    conv_fwd = graph_ms(lambda: F.conv2d(x, w3, b4, 1, 1))

    gout = torch.randn(out.shape, generator=gen).to("cuda", dtype)
    od = out if act is not None else None
    dx = sc.small_conv_dx(gout, w3, x.shape, 1, od, act)
    torch.cuda.synchronize()
    err = check_close(f"deconv dx {tag}", dx, sc.conv_dx_plain(
        gout.float(), w3.float(), x.shape, 1,
        None if od is None else od.float(), act), tol)
    gk = sc._act_grad(gout, od, act)
    g_up = F.pixel_shuffle(gk, 2)
    xf = x.float().requires_grad_()
    (xf_grad,) = torch.autograd.grad(F.conv_transpose2d(
        xf, wt.float(), bias.float(), 2, 1), xf, g_up.float())
    check_close(f"deconv dx {tag} vs conv_transpose2d", dx, xf_grad, tol)
    row("small_conv_dx", dtype, shape, err,
        graph_ms(lambda: sc.small_conv_dx(gout, w3, x.shape, 1, od, act)),
        graph_ms(lambda: sc.conv_dx_plain(gout, w3, x.shape, 1, od, act)),
        graph_ms(lambda: torch.ops.aten.convolution_backward(
            g_up, x, wt, None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
            [True, False, False])),
        (gout.numel() * (2 if act else 1) + wt.numel() + x.numel()) * isz,
        flops, path, "graph",
        cuda_ms(lambda: sc.small_conv_dx(gout, w3, x.shape, 1, od, act)))
    conv_dx = graph_ms(lambda: torch.ops.aten.convolution_backward(
        gk, x, w3, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, False, False]))
    log(f"    {tag}: the combined 3x3 conv in cuDNN: fwd {conv_fwd:.4f} ms, "
        f"dx {conv_dx:.4f} ms")


def kernels_flownet2_conv(rows):
    """The small conv at every distinct shape of FlowNet2's 41 launches per
    forward at 384×1280 (1 pair): 14 `CL` (leaky; k7/k5 stride 2, C_in 3,
    6, 11, 12, 64), 7 `PlainConv` (C_in up to 162, C_out ≤ 32) and 20
    transposed convs run as one 3×3 conv each (`deconv_rows`), bf16 (the
    main path's dtype), graph-timed; then each time summed over the 41
    launches of one forward (and the dx of one closure's backward). Float32
    (the CUDA-core route, which no main path runs) at the k5 stride-2 shape
    and Fusion's deconv0."""
    gen = torch.Generator().manual_seed(6)
    row = row_adder(rows)
    log("# small conv vs plain (FlowNet2's 41 per forward at 384x1280, "
        "1 pair)")
    f32 = [c for c in FN2_CONVS if c[6] == 5 or c[0] == "Fusion deconv0"]
    for dtype, tol, convs in ((torch.bfloat16, 3e-2, FN2_CONVS),
                              (torch.float32, 1e-4, f32)):
        counts = []
        for tag, n, c_in, h, w, c_out, k, s, act in convs:
            kind = "deconv" if k == 4 else "conv"
            label = f"{tag} {kind} k{k} s{s} {c_in}->{c_out}"
            if k == 4:
                deconv_rows(row, gen, dtype, tol, label, "FlowNet2",
                            (FN2_PAIRS, c_in, h, w, c_out), act)
            else:
                conv_rows(row, gen, dtype, tol, label, "FlowNet2",
                          (FN2_PAIRS, c_in, h, w, c_out, k, s), act,
                          graph=True)
            counts += [n, n]
            torch.cuda.empty_cache()
        if dtype != torch.bfloat16:
            continue
        sums = {}
        for n, r in zip(counts, rows[-len(counts):]):
            acc = sums.setdefault(r["name"], dict.fromkeys(
                ("ms", "plain_ms", "library_ms", "bound_ms"), 0.0))
            for k in acc:
                acc[k] += n * r[k]
        log(f"# small conv, FlowNet2's {sum(counts) // 2} launches per "
            f"forward, bf16 (graph-timed, warm L2): " + "; ".join(
                f"{name} kernel {a['ms']:.4f} ms, plain {a['plain_ms']:.4f}"
                f" ms, library {a['library_ms']:.4f} ms, bound "
                f"{a['bound_ms']:.4f} ms" for name, a in sums.items())
            + f" [{card_line()}]")


def valid_products(H: int, W: int, patch: int, stride: int) -> int:
    """(pixel, shift) pairs whose shifted pixel lies in the map: the
    products the correlation needs (zero padding needs none)."""
    R = (patch - 1) // 2 * stride
    offs = [i * stride - R for i in range(patch)]
    return (sum(max(0, H - abs(d)) for d in offs)
            * sum(max(0, W - abs(d)) for d in offs))


def kernels_local_corr(rows):
    """Patch correlation, forward and backward, at every PWCNet level at
    384×1280 (B = 1, patch 9) and at FlowNetC's shape (patch 21, stride
    2), float32 and bf16. Kernel times are device times by CUDA-graph
    replay (the loop time beside them); the plain versions are loop-timed.
    No single PyTorch call computes it: library_ms is null. Kernel and
    plain version sum the same float32 products in another order (float32:
    1e-4) and each rounds once to bf16 (one bf16 ulp, at most 2⁻⁷ of a
    value: 1e-2), relative to the largest plain value. Prints each time
    summed over the five levels, as one closure runs them (each level's
    forward and backward once)."""
    from pcfa_tpu_torch.ops import local_corr as lc

    gen = torch.Generator().manual_seed(1)
    row = row_adder(rows)
    log("# patch correlation vs plain (PWCNet levels at 384x1280, B = 1)")
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        isz = torch.empty((), dtype=dtype).element_size()
        shapes = [("FlowNetC", 48, 160, 256, 21, 2)] + [
            (n, h, w, c, 9, 1) for n, h, w, c in PWC_LEVELS]
        for tag, h, w, c, patch, stride in shapes:
            f1, f2 = (torch.randn((PWC_PAIRS, h, w, c), generator=gen)
                      .to("cuda", dtype) for _ in range(2))
            out = lc.local_corr_fwd(f1, f2, patch, stride)
            torch.cuda.synchronize()
            err = check_close(f"local corr fwd {tag}", out,
                              lc.local_corr_plain(f1, f2, patch, stride), tol)
            shape = f"{tag} {PWC_PAIRS}x{h}x{w}x{c} p{patch} s{stride}"
            path = "FlowNet2" if tag == "FlowNetC" else "PWCNet"
            prods = PWC_PAIRS * valid_products(h, w, patch, stride) * c
            fwd = lambda: lc.local_corr_fwd(f1, f2, patch, stride)  # noqa
            row("local_corr_fwd", dtype, shape, err, graph_ms(fwd),
                cuda_ms(lambda: lc.local_corr_plain(f1, f2, patch, stride),
                        reps=3), None,
                (f1.numel() + f2.numel() + out.numel()) * isz, 2 * prods,
                path, "graph", cuda_ms(fwd))
            g = torch.randn(out.shape, generator=gen).to("cuda", dtype)
            got = lc.local_corr_bwd(g, f1, f2, patch, stride)
            ref = lc.local_corr_bwd_plain(g, f1, f2, patch, stride)
            torch.cuda.synchronize()
            err = max(check_close(f"local corr bwd {tag} {i}", a, b, tol)
                      for i, (a, b) in enumerate(zip(got, ref)))
            bwd = lambda: lc.local_corr_bwd(g, f1, f2, patch, stride)  # noqa
            row("local_corr_bwd", dtype, shape, err, graph_ms(bwd),
                cuda_ms(lambda: lc.local_corr_bwd_plain(g, f1, f2, patch,
                                                        stride), reps=3),
                None, (g.numel() + 4 * f1.numel()) * isz, 4 * prods, path,
                "graph", cuda_ms(bwd))
            del f1, f2, out, g, got, ref
        # the rows just added: forward, backward for each shape in turn
        pwc = [r for r in rows[-2 * len(shapes):] if r["path"] == "PWCNet"]
        sums = {k: {n: sum(r[k] for r in pwc if r["name"] == n)
                    for n in ("local_corr_fwd", "local_corr_bwd")}
                for k in ("ms", "plain_ms", "bound_ms")}
        log(f"# patch correlation, PWCNet's five levels per closure, "
            f"{str(dtype)[6:]} (graph-timed, warm L2): " + "; ".join(
                f"{n} kernel {sums['ms'][n]:.4f} ms, plain "
                f"{sums['plain_ms'][n]:.4f} ms, bound "
                f"{sums['bound_ms'][n]:.4f} ms" for n in sums["ms"])
            + f"; fwd + bwd kernel {sum(sums['ms'].values()):.4f} ms, bound "
            f"{sum(sums['bound_ms'].values()):.4f} ms [{card_line()}]")


def warp_state(gen, shape, dtype, zeros, collide=False, spynet=False):
    """The packed sampler's saved forward state and a float32 cotangent
    (the warp's output is promoted to float32) on the card, as
    `warp_bwd`'s first seven arguments: one sample per pixel at the pixel
    grid plus a random flow of a few pixels (border mode: clamped to the
    image, as `grid_sample` clamps), or with `collide` every sample in
    one 8×8 patch (a few samples per window base), or with `spynet` at
    SpyNet's grid (`spynet_warp`: the grid clipped to [−1, 1], sampled
    with align_corners=False, so a clipped sample lies half a pixel
    outside the image and takes half its value from the zero border) for
    a flow of 5% of the width."""
    from pcfa_tpu_torch.ops.warp import _corner_weights, _pack_windows

    B, H, W, C = shape
    img = torch.randn(shape, generator=gen).to("cuda", dtype)
    if collide:
        ix, iy = (10.0 + 8.0 * torch.rand((B, H, W), generator=gen)
                  for _ in range(2))
    elif spynet:
        xs, ys = torch.linspace(-1.0, 1.0, W), torch.linspace(-1.0, 1.0, H)
        base = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1)
        flow = 0.05 * W * torch.randn((B, H, W, 2), generator=gen)
        grid = (base + flow / torch.tensor([(W - 1) / 2, (H - 1) / 2])
                ).clamp(-1.0, 1.0)
        ix = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
        iy = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    else:
        ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W),
                                indexing="ij")
        flow = 2.0 * torch.randn((B, H, W, 2), generator=gen)
        ix, iy = xs + flow[..., 0], ys + flow[..., 1]
        if not zeros:
            ix, iy = ix.clamp(0, W - 1), iy.clamp(0, H - 1)
    idx, w4, mask4, a, b = _corner_weights(shape, ix.to("cuda"),
                                           iy.to("cuda"), zeros)
    win = _pack_windows(img)[idx].reshape(-1, 4, C)
    g = torch.randn((B, H, W, C), generator=gen).to("cuda")
    return [g, win, idx, w4, mask4, a, b], (ix, iy), img


def kernels_warp_bwd(rows):
    """The packed sampler's backward (d img, d ix, d iy in one kernel) at
    PWCNet's four warps at 384×1280 (B = 1, zeros mode), a collision case
    (level 2's samples in one 8×8 patch), FlowNet2's full-resolution
    border warp of 3-channel images (B = 1, 384×1280) and SpyNet's six
    warps of 3-channel images at 384×1280 (2 pairs, zeros mode, the grid
    clipped to [−1, 1] and sampled with align_corners=False), with bf16
    (PWCNet's and SpyNet's main path) and float32 images. Checked against
    the plain version on the same inputs, 1e-4 of the largest plain value
    (float32 sums in the atomics' varying order), d img taken as the
    float32 accumulator;
    kernel times are the whole contract (zero fill, kernel, the cast of a
    bf16 image's gradient), graph-timed. Library: one
    `grid_sampler_2d_backward` (NCHW, float32 input and grid, both
    gradients). Bound: every input read once (g, the saved corners, idx,
    weights, fractions, mask), d img in the image's dtype and d ix, d iy
    written once; 16 float32 operations per sample and channel (four dot
    products, four scaled adds). Prints the four PWCNet warps' and the
    six SpyNet warps' sums per closure."""
    from pcfa_tpu_torch.ops import segsum as sg

    gen = torch.Generator().manual_seed(2)
    row = row_adder(rows)
    log("# warp backward vs plain (PWCNet's warps and FlowNet2's image "
        "warp at 384x1280, B = 1; SpyNet's six warps, 2 pairs)")
    cases = ([(n, (PWC_PAIRS, h, w, c), True, {}, "PWCNet")
              for n, h, w, c in PWC_LEVELS[1:]]
             + [("L2 collide", (PWC_PAIRS, 96, 320, 32), True,
                 {"collide": True}, None),
                ("FlowNet2 border", (1, 384, 1280, 3), False, {},
                 "FlowNet2")]
             + [(f"SpyNet L{i}", (PAIRS, h, w, 3), True, {"spynet": True},
                 "SpyNet") for i, (h, w) in enumerate(SPY_LEVELS)])
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.empty((), dtype=dtype).element_size()
        for tag, shape, zeros, kind, path in cases:
            B, H, W, C = shape
            state, (ix, iy), img = warp_state(gen, shape, dtype, zeros,
                                              **kind)
            got = sg.warp_bwd_cuda(*state, shape, torch.float32)
            ref = sg.warp_bwd_plain(*state, shape, torch.float32)
            torch.cuda.synchronize()
            err = max(check_close(f"warp bwd {tag} {what}", x, y, 1e-4)
                      for what, x, y in zip(("d img", "d ix", "d iy"), got,
                                            ref))
            g, a = state[0], state[5]
            nbytes = (sum(t.numel() * t.element_size() for t in state
                          if t is not None)
                      + B * H * W * C * isz + 2 * a.numel() * 4)
            grid = torch.stack([(2 * ix + 1) / W - 1, (2 * iy + 1) / H - 1],
                               -1).to("cuda")
            gl, il = (t.permute(0, 3, 1, 2).float().contiguous()
                      for t in (g, img))
            kernel = lambda: sg.warp_bwd_cuda(*state, shape, dtype)  # noqa
            row("warp_bwd", dtype, f"{tag} {B}x{H}x{W}x{C} N={a.numel()}",
                err, graph_ms(kernel),
                cuda_ms(lambda: sg.warp_bwd_plain(*state, shape, dtype)),
                graph_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                    gl, il, grid, 0, 0 if zeros else 1, False,
                    [True, True])),
                nbytes, 16 * a.numel() * C, path, "graph", cuda_ms(kernel))
            del state, img, got, ref, grid, gl, il
        for net, what in (("PWCNet", "four"), ("SpyNet", "six")):
            sums = {k: sum(r[k] for r in rows[-len(cases):]
                           if r["path"] == net)
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"# warp backward, {net}'s {what} warps per closure, "
                f"{str(dtype)[6:]} image (graph-timed, warm L2): kernel "
                f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, "
                f"library {sums['library_ms']:.4f} ms, bound "
                f"{sums['bound_ms']:.4f} ms [{card_line()}]")


# the compact L-BFGS direction's history as each main path gives it:
# (pairs, padded H, W, history dtype, path); RAFT, GMA and RAFT-small pad
# to ÷8, SpyNet, FlowNet2 and PWCNet to ÷64; PWCNet's history is float32
HIST_CASES = [(PAIRS, 376, 1248, torch.bfloat16, "RAFT"),
              (16, 376, 1248, torch.bfloat16, "RAFT b16"),
              (PAIRS, 384, 1280, torch.bfloat16, "SpyNet"),
              (FN2_PAIRS, 384, 1280, torch.bfloat16, "FlowNet2"),
              (PWC_PAIRS, 384, 1280, torch.float32, "PWCNet")]


def kernels_lbfgs_hist(rows):
    """The compact L-BFGS direction's two passes (`ops/lbfgs_hist.py`) at
    each main path's shape and history dtype (`HIST_CASES`: n = 2·3·H·W,
    history 100, the ring full and wrapped: count 137), against the plain
    chunked versions on the same inputs (1e-4 of the largest plain value:
    float32 sums in another order), graph-timed (each pass is
    milliseconds: the L2 holds none of the ring). Library: `torch.bmm` on
    the ring in its dtype (S with [g, y] and Y with [g, y, s]; the two
    coefficient rows times S and Y), as a yardstick only. Bound: the ring
    read once, g, y, s (products) or g and d (combine) in float32 once."""
    from pcfa_tpu_torch.ops import lbfgs_hist as lh

    row = row_adder(rows)
    m = 100
    log("# L-BFGS history passes vs plain (history 100, full ring)")
    for pairs, h, w, hdt, path in HIST_CASES:
        n = 2 * 3 * h * w
        gen = torch.Generator(device="cuda").manual_seed(3)
        S, Y = (torch.randn((pairs, m, n), generator=gen, device="cuda",
                            dtype=hdt) for _ in "SY")
        vecs = [torch.randn((pairs, n), generator=gen, device="cuda")
                for _ in "gys"]
        top, bot = (torch.randn((pairs, m), generator=gen, device="cuda")
                    for _ in "tb")
        gamma = torch.rand(pairs, generator=gen, device="cuda") + 0.5
        cnt = torch.full((pairs,), 137, dtype=torch.int64, device="cuda")
        reps = 5 if pairs > PAIRS else 20
        shape = f"{pairs}x{m}x{n}"
        ring = 2 * pairs * m * n * S.element_size()

        err = check_close(f"lbfgs products {path}",
                          lh.hist_products(S, Y, *vecs, cnt),
                          lh.hist_products_plain(S, Y, *vecs, cnt), 1e-4)
        rhs = torch.stack(vecs, 2).to(hdt)
        kernel = lambda: lh.hist_products(S, Y, *vecs, cnt)  # noqa: E731
        row("lbfgs_hist_products", hdt, shape, err, graph_ms(kernel, reps),
            graph_ms(lambda: lh.hist_products_plain(S, Y, *vecs, cnt), reps),
            graph_ms(lambda: (torch.bmm(S, rhs[..., :2]), torch.bmm(Y, rhs)),
                     reps),
            ring + 3 * pairs * n * 4 + pairs * 5 * m * 4,
            10 * pairs * m * n, path, "graph", cuda_ms(kernel, 3, 1))
        del rhs

        args = (S, Y, vecs[0], top, bot, gamma, cnt)
        err = check_close(f"lbfgs combine {path}", lh.hist_combine(*args),
                          lh.hist_combine_plain(*args), 1e-4)
        cs, cy = (c.to(hdt)[:, None] for c in (top, bot))
        kernel = lambda: lh.hist_combine(*args)  # noqa: E731
        row("lbfgs_hist_combine", hdt, shape, err, graph_ms(kernel, reps),
            graph_ms(lambda: lh.hist_combine_plain(*args), reps),
            graph_ms(lambda: (torch.bmm(cs, S), torch.bmm(cy, Y)), reps),
            ring + 2 * pairs * n * 4 + 2 * pairs * m * 4,
            4 * pairs * m * n, path, "graph", cuda_ms(kernel, 3, 1))
        del S, Y, vecs, args
        torch.cuda.empty_cache()


def compare_warp():
    """The warp backward in a form any tree of the port runs, for a
    parent-vs-change comparison in one call (copy this script into the
    other tree): at each of PWCNet's four warps at 384×1280 (B = 1, bf16
    features, float32 grid as `pwc_warp` builds it, float32 cotangent),
    `grid_sample`'s backward through autograd to the image and the grid:
    device time by CUDA-graph replay (forward + backward less the
    forward), time between CUDA events over 10 backwards issued from
    Python (the host's pace), and the device launches of one backward
    (`torch.profiler`), both of the whole `grid_sample` backward and of
    the sampler's own (`_PackedBilinear` on leaf coordinates); then their
    sums per closure. Times only; `kernels_warp_bwd` checks the values."""
    from torch.profiler import ProfilerActivity, profile

    from pcfa_tpu_torch.ops.warp import _PackedBilinear, grid_sample

    def launches(fn) -> int:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # a program span (`op.warp.bwd`) shows on the device too, as an
        # annotation of its host event's name: not a launch
        events = prof.key_averages()
        host = {e.key for e in events
                if e.device_type == torch.autograd.DeviceType.CPU}
        return sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key not in host)

    gen = torch.Generator().manual_seed(4)
    total = dict.fromkeys(("graph", "loop", "launches", "own"), 0.0)
    card = card_line()
    for tag, h, w, c in PWC_LEVELS[1:]:
        img = (torch.randn((PWC_PAIRS, h, w, c), generator=gen)
               .to("cuda", torch.bfloat16).requires_grad_())
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
        flow = 2.0 * torch.randn((PWC_PAIRS, h, w, 2), generator=gen)
        grid = torch.stack([2.0 * (xs + flow[..., 0]) / (w - 1) - 1.0,
                            2.0 * (ys + flow[..., 1]) / (h - 1) - 1.0], -1)
        grid = grid.to("cuda").requires_grad_()
        g = torch.randn((PWC_PAIRS, h, w, c), generator=gen).to("cuda")
        fwd = graph_ms(lambda: grid_sample(img, grid))
        both = graph_ms(lambda: torch.autograd.grad(
            grid_sample(img, grid), (img, grid), g))
        out = grid_sample(img, grid)
        bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, (img, grid), g, retain_graph=True)
        loop = cuda_ms(bwd)
        n_all = launches(bwd)
        ix, iy = (t.detach().requires_grad_() for t in (
            (grid[..., 0].detach() + 1.0) * 0.5 * w - 0.5,
            (grid[..., 1].detach() + 1.0) * 0.5 * h - 0.5))
        own = _PackedBilinear.apply(img, ix, iy, True)
        n_own = launches(lambda: torch.autograd.grad(
            own, (img, ix, iy), g, retain_graph=True))
        for k, v in (("graph", both - fwd), ("loop", loop),
                     ("launches", n_all), ("own", n_own)):
            total[k] += v
        log(f"# compare warp {tag} {PWC_PAIRS}x{h}x{w}x{c}: backward "
            f"{both - fwd:.4f} ms graph-timed (fwd+bwd {both:.4f}, fwd "
            f"{fwd:.4f}), {loop:.4f} ms between CUDA events; device "
            f"launches per backward {n_all} (the sampler's own {n_own}) "
            f"[{card}]")
        del img, grid, g, out, own
    log(f"# compare warp, PWCNet's four warps per closure: backward "
        f"{total['graph']:.4f} ms graph-timed, {total['loop']:.4f} ms "
        f"between CUDA events; device launches {int(total['launches'])} "
        f"(the sampler's own {int(total['own'])}) [{card}]")
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ 3 ---

def run_flow(model, dev, inputs, g) -> list[torch.Tensor]:
    """flow_up and the input gradients of Σ flow_up·g, on `dev`, as float64
    on the CPU."""
    a = inputs[0].clone().to(dev).requires_grad_(True)
    b = inputs[1].clone().to(dev).requires_grad_(True)
    up = model(a, b)
    up = up[-1] if isinstance(up, tuple) else up
    (up * g.to(dev)).sum().backward()
    return [t.detach().cpu().double() for t in (up, a.grad, b.grad)]


def check_agree(name, ref, got):
    """Two `run_flow` results on the same float32 inputs. Flows: rtol/atol
    1e-3. Input gradients: float32 rounding switches a few ReLU/LeakyReLU
    units of a random-init net on or off (pre-activations within ~1e-6 of
    the kink), which moves single gradient elements by up to ~5e-3 of a
    ~0.2 scale on both devices alike; so the gradients are held to a
    relative L2 error of 1e-2 and 99.5% of their elements to rtol/atol
    1e-3."""
    (up_c, *grads_c), (up_g, *grads_g) = ref, got
    err_up = float((up_g - up_c).abs().max())
    if not torch.allclose(up_g, up_c, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"parity {name}: flow max abs err {err_up}")
    worst = []
    for what, gg, gc in zip(("d image1", "d image2"), grads_g, grads_c):
        rel_l2 = float((gg - gc).norm() / gc.norm())
        within = float(((gg - gc).abs() <= 1e-3 + 1e-3 * gc.abs())
                       .double().mean())
        worst.append((what, rel_l2, within, float((gg - gc).abs().max())))
        if not (rel_l2 <= 1e-2 and within >= 0.995):
            raise AssertionError(f"parity {name}: {what} rel L2 {rel_l2}, "
                                 f"{within:.4%} within tolerance")
    log(f"# parity {name}: flow max abs err {err_up:.3g} "
        f"(scale {float(up_c.abs().max()):.3g}); " + "; ".join(
            f"{n}: rel L2 {r:.3g}, {w:.4%} within 1e-3, max abs {m:.3g}"
            for n, r, w, m in worst))


def check_against_f64(name, ref, got, truth, jittered=()):
    """Two float32 `run_flow` results, CPU (`ref`) and card (`got`), and
    the CPU's float64 one (`truth`), for a net whose float32 input
    gradients are far from its float64 ones on the CPU alone: the flows
    at rtol/atol 1e-3; each gradient's relative L2 error against float64
    at most twice the CPU float32's (at least 1e-6), and the card's within
    1e-2 of the CPU's. The kernels then add no more error than float32
    rounding already makes.

    `jittered`: more CPU float32 results at inputs moved by about one
    float32 ulp, for a net whose float32 gradient error is itself spread
    widely by rounding (FlowNet2's moves between 1.6e-3 and 7.6e-3 of its
    norm under such jitter, on the CPU alone): the card's error against
    float64 is then held to twice the largest CPU float32 error of all
    those runs, which takes the place of the 1e-2 card-to-CPU limit (two
    draws from that band lie up to twice its width apart)."""
    (up_c, *grads_c), (up_g, *grads_g), (_, *grads_t) = ref, got, truth
    err_up = float((up_g - up_c).abs().max())
    if not torch.allclose(up_g, up_c, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"parity {name}: flow max abs err {err_up}")
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    worst = []
    for i, (what, gg, gc, gt) in enumerate(zip(("d image1", "d image2"),
                                               grads_g, grads_c, grads_t)):
        e_card, e_pair = rel(gg, gt), rel(gg, gc)
        e_cpu = max(rel(r[1 + i], gt) for r in (ref, *jittered))
        worst.append((what, e_card, e_cpu, e_pair))
        if not (e_card <= max(2 * e_cpu, 1e-6)
                and (jittered or e_pair <= 1e-2)):
            raise AssertionError(
                f"parity {name}: {what} rel L2 to float64: card {e_card}, "
                f"CPU {e_cpu}; card to CPU {e_pair}")
    band = (f" (the largest of {1 + len(jittered)} runs, inputs jittered "
            "by ~1 ulp)" if jittered else "")
    log(f"# parity {name}: flow max abs err {err_up:.3g} "
        f"(scale {float(up_c.abs().max()):.3g}); " + "; ".join(
            f"{n}: rel L2 to the CPU's float64, card {c:.3g}, CPU float32 "
            f"{p:.3g}{band}; card to CPU {q:.3g}" for n, c, p, q in worst))


def card_vs_cpu(name, models, inputs, g, f64=False, jitter=0):
    """Run `models` {'cpu', 'cuda'} on the same float32 inputs, backprop
    Σ flow·g and compare (`check_agree`); with `f64` against the CPU
    model's float64 run as well (`check_against_f64`), with `jitter` more
    CPU float32 runs at inputs scaled by 1 + 2e-7·N(0, 1)."""
    import copy

    ref = run_flow(models["cpu"], "cpu", inputs, g)
    got = run_flow(models["cuda"], "cuda", inputs, g)
    if not f64:
        check_agree(f"card vs CPU ({name})", ref, got)
        return
    truth = run_flow(copy.deepcopy(models["cpu"]).double(), "cpu",
                     [t.double() for t in inputs], g.double())
    gen = torch.Generator().manual_seed(100)
    jittered = [run_flow(models["cpu"], "cpu", [
        t * (1 + 2e-7 * torch.randn(t.shape, generator=gen))
        for t in inputs], g) for _ in range(jitter)]
    check_against_f64(f"card vs CPU ({name})", ref, got, truth, jittered)


def damped(loaded, gamma=None):
    """The module of `loaded` with its flow head's conv2 damped ×0.01, as
    the parity tests do (a random recurrent net stays tame); GMA's residual
    gain set to `gamma` (at its initial 0 the aggregation adds nothing)."""
    m = loaded.module
    with torch.no_grad():
        m.update_block.flow_head.conv2.weight.mul_(0.01)
        m.update_block.flow_head.conv2.bias.mul_(0.01)
        if gamma is not None:
            m.update_block.aggregator.gamma.fill_(gamma)
    return m


def phase_parity():
    """Card (kernels) vs CPU (plain versions), float32, each 128×128, 2
    pairs: RAFT (flow-head conv2 damped ×0.01, 3 iterations), PWCNet, GMA
    (also damped, gamma 0.5, 3 iterations), RAFT-small (damped, 3
    iterations), SpyNet (6 levels), FlowNet2 (1 pair; SpyNet and FlowNet2
    also against the CPU's float64), RAFT with the fused corr path (blocks
    of 100 of each pair's 256 queries), with the hybrid one, and with
    remat (which must also agree with the card without remat)."""
    import copy

    from pcfa_tpu_torch.runtime import load_model

    rng = np.random.default_rng(0)
    i1, i2 = (torch.from_numpy(rng.random((2, 128, 128, 3)).astype(np.float32))
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((2, 128, 128, 2))
                         .astype(np.float32))

    def both(module):
        return {"cpu": module, "cuda": copy.deepcopy(module).to("cuda")}

    def raft(**kw):
        return damped(load_model("RAFT", init_random=True, seed=0,
                                 device="cpu", iters=3, **kw))

    card_vs_cpu("RAFT 128x128, 3 iters, fp32", both(raft()), (i1, i2), g)
    loaded = load_model("PWCNet", init_random=True, seed=0, device="cpu")
    card_vs_cpu("PWCNet 128x128, fp32", both(loaded.module), (i1, i2), g)
    gma = damped(load_model("GMA", init_random=True, seed=0, device="cpu",
                            iters=3), gamma=0.5)
    card_vs_cpu("GMA 128x128, 3 iters, gamma 0.5, fp32", both(gma),
                (i1, i2), g)
    small = damped(load_model("RAFT-small", init_random=True, seed=0,
                              device="cpu", iters=3))
    card_vs_cpu("RAFT-small 128x128, 3 iters, fp32", both(small), (i1, i2),
                g)
    # a random SpyNet's float32 input gradients differ from its float64
    # ones by 1e-3 to 3e-3 of their norm on the CPU alone (the CPU's float32
    # convolutions set which), more than `check_agree`'s elementwise share
    # allows between two float32 runs: they are held against float64
    spynet = load_model("SpyNet", init_random=True, seed=0, device="cpu")
    card_vs_cpu("SpyNet 128x128, 6 levels, fp32", both(spynet.module),
                (i1, i2), g, f64=True)
    # FlowNet2 likewise, one pair: its float32 input gradients lie 2e-4 to
    # 8e-3 (rel L2) from its float64 ones on the CPU alone, as the inputs
    # move by one float32 ulp; so against the band of 3 jittered runs
    fn2 = load_model("FlowNet2", init_random=True, seed=0, device="cpu")
    card_vs_cpu("FlowNet2 128x128, 1 pair, fp32", both(fn2.module),
                (i1[:1], i2[:1]), g[:1], f64=True, jitter=3)
    del fn2
    card_vs_cpu("RAFT corr_impl='fused', corr_block 100, fp32",
                both(raft(corr_impl="fused", corr_block=100)), (i1, i2), g)
    card_vs_cpu("RAFT corr_impl='hybrid', fp32",
                both(raft(corr_impl="hybrid")), (i1, i2), g)
    remat = both(raft(remat=True))
    card_vs_cpu("RAFT remat=True, fp32", remat, (i1, i2), g)
    check_agree("card, RAFT remat=True vs without remat",
                run_flow(raft().to("cuda"), "cuda", (i1, i2), g),
                run_flow(remat["cuda"], "cuda", (i1, i2), g))


# ------------------------------------------------------------------ 4 ---

def profile_step(step, what: str = "one outer step", top: int = 30) -> None:
    """One call of `step` under `torch.profiler`: device busy share, device
    launches (kernels, fills and copies) and the `top` kernels by device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t)
    # device-side events only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"# profile of {what}: wall {wall_us / 1e3:.1f} ms (profiler "
        f"on), device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / wall_us:.1f}%), device launches "
        f"{sum(e.count for e in events)}; top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"#   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:110]}")


def host_probe() -> float:
    """The host's cost per kernel launch: 2,000 tiny in-place adds issued
    back to back (Python, dispatcher and launch; the device finishes each
    in ~2 µs), in µs per launch."""
    t = torch.zeros(1, device="cuda")
    for _ in range(200):
        t.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        t.add_(1.0)
    torch.cuda.synchronize()
    us = 1e6 * (time.perf_counter() - t0) / 2000
    log(f"# host: {us:.3f} µs per tiny kernel launch (2000 back to back) "
        f"[{card_line()}]")
    return us


def phase_main_path(net: str, pairs: int, profile: bool = False) -> dict:
    """The PCFA attack on full `net` at the KITTI shape, random pairs, from
    the entry points a user calls; the environment (compute dtype, L-BFGS
    direction and history dtype) is the caller's. Returns the launches of
    every kernel during the run (and prints those of one closure)."""
    from pcfa_tpu_torch import config
    from pcfa_tpu_torch.attack import pcfa
    from pcfa_tpu_torch.runtime import load_model, make_flow_fn
    from pcfa_tpu_torch.utils import profiling

    cfg = pcfa.PCFAConfig(
        steps=2, max_iter=2, delta_bound=0.005, loss="aee", target="zero",
        boxconstraint="clipping", history_size=100,
        lbfgs_direction=config.lbfgs_direction(),
        lbfgs_history_dtype=config.lbfgs_history_dtype(net))
    loaded = load_model(net, init_random=True, seed=0)
    padder, flow_fn = make_flow_fn(loaded, KITTI_HW, pad_mode="kitti")
    log(f"# main path: {net}, {KITTI_HW[0]}x{KITTI_HW[1]} "
        f"padded to {padder.padded_shape} (÷{loaded.spec.pad_divisor}), "
        f"pairs {pairs}, compute {os.environ.get('PCFA_COMPUTE_DTYPE')}, "
        f"config {cfg}")
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.random((pairs, *KITTI_HW, 3))
                             .astype(np.float32)).cuda() for _ in range(2)]
    image1, image2 = padder.pad(*imgs)
    target = torch.zeros((pairs, *KITTI_HW, 2), device="cuda")

    host_probe()
    hist = hist_wrappers() if cfg.lbfgs_direction == "compact" else {}
    wrappers = {name: wrapper(name) for name, *_ in KERNELS} | hist
    for w in wrappers.values():
        w.launches = 0
    c0 = profiling.counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, flow_init = pcfa.pcfa_init(flow_fn, image1, image2, cfg)
    torch.cuda.synchronize()
    t_steps = []
    for _ in range(cfg.steps):
        t = time.perf_counter()
        state, metrics, flow_pred = pcfa.pcfa_outer_step(
            flow_fn, image1, image2, target, flow_init, state, cfg)
        torch.cuda.synchronize()
        t_steps.append(time.perf_counter() - t)
    t_run = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    c1 = profiling.counters()
    iters = c1.get("lbfgs.iterations", 0) - c0.get("lbfgs.iterations", 0)
    peak = torch.cuda.max_memory_allocated()

    for name, v in metrics._asdict().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"main path {net}: metric {name} not "
                                 f"finite: {v}")
    if not (torch.isfinite(flow_pred).all() and torch.isfinite(state.opt.x)
            .all()):
        raise AssertionError(f"main path {net}: non-finite flow or iterate")
    if flow_pred.shape != (pairs, *KITTI_HW, 2):
        raise AssertionError(f"main path {net}: flow shape "
                             f"{tuple(flow_pred.shape)}")
    missing = [k for k in PATH_KERNELS[net] if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path {net} never launched {missing}")
    # every compact direction goes through both history kernels
    short = {k: launches[k] for k in hist if launches[k] != iters}
    if hist and (iters == 0 or short):
        raise AssertionError(f"main path {net}: {iters} L-BFGS iterations, "
                             f"history kernel launches {short}")

    # per-closure and forward times, measured after the run
    _, _, _, value_and_grad = pcfa._make_problem(flow_fn, image1, image2,
                                                 target, cfg)
    x = state.opt.x
    closure_s, fwd_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        value_and_grad(x)
        torch.cuda.synchronize()
        closure_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        with torch.no_grad():
            flow_fn(image1, image2)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t)
    closure, fwd = min(closure_s), min(fwd_s)
    for w in wrappers.values():
        w.launches = 0
    value_and_grad(x)
    per_closure = {name: w.launches for name, w in wrappers.items()
                   if w.launches}
    if profile:
        profile_step(lambda: pcfa.pcfa_outer_step(
            flow_fn, image1, image2, target, flow_init, state, cfg))
        profile_step(lambda: value_and_grad(x), "one closure", top=10)
    it_s = (t_steps[-1] - fwd) / cfg.max_iter
    published = (20 * 10 * it_s + 21 * fwd) / pairs
    card = card_line()
    log(f"# main path {net} metrics (last step, per pair): " + ", ".join(
        f"{k} {v.tolist()}" for k, v in metrics._asdict().items()))
    log(f"# main path {net}: run {t_run:.3f} s ({cfg.steps} steps × "
        f"{cfg.max_iter} iters, {pairs} pairs) = {pairs / t_run:.4f} pairs/s;"
        f" outer steps {[round(t, 3) for t in t_steps]} s; closure "
        f"(fwd+bwd, {pairs} pairs) {1e3 * closure:.1f} ms (of 3: "
        f"{[round(1e3 * t, 1) for t in closure_s]}); forward "
        f"{1e3 * fwd:.1f} ms; L-BFGS iteration {1e3 * it_s:.1f} ms; "
        f"extrapolated to the published config, pairs / (200 · iteration + "
        f"21 · forward): {1 / published:.5f} pairs/s (not a run of it); "
        f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    log(f"# main path {net} launches: {json.dumps(launches)}; per closure "
        f"(forward and backward, {pairs} pairs): {json.dumps(per_closure)}")
    return launches


# ------------------------------------------------------------------ 7 ---

def phase_corr_paths(pairs: int = PAIRS, profile: bool = False) -> dict:
    """One forward+backward closure (Σ flow·g to both images) of full RAFT
    (12 iterations, bf16 network, random weights from seed 0) at 2× KITTI,
    750×2484 padded to 752×2488, for `pairs` pairs, through each corr
    path: 'auto', which must resolve to 'fused' there (the materialized
    pyramid's estimate exceeds the default 6 GiB budget), 'hybrid', and
    'materialized', forced by PCFA_CORR_HBM_BUDGET_MB. The path taken is
    read from RAFT's call of `make_corr_lookup`. Per path: two closures'
    wall times (CUDA-synchronised), peak memory, the lookup kernel's
    launches. Flows and gradients must be finite; the fused and hybrid
    flows must agree with the materialized one within 2e-2 of its largest
    magnitude (bf16 networks: the paths round the correlation differently,
    and 12 iterations carry it on; a CPU run of these three paths at
    256×256 agreed within 4e-3). `profile` adds a profiler table of one
    closure per path."""
    from pcfa_tpu_torch.models import raft as raft_module
    from pcfa_tpu_torch.ops import corr_lookup as cl
    from pcfa_tpu_torch.ops.correlation import resolve_corr_impl
    from pcfa_tpu_torch.runtime import load_model, make_flow_fn

    hw = (2 * KITTI_HW[0], 2 * KITTI_HW[1])
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.random((pairs, *hw, 3)).astype(np.float32))
            .cuda() for _ in range(2)]
    g = torch.from_numpy(rng.standard_normal((pairs, *hw, 2))
                         .astype(np.float32)).cuda()
    taken = []
    make_lookup = raft_module.make_corr_lookup

    def recording(impl, *args):
        taken.append(impl)
        return make_lookup(impl, *args)

    card, res = card_line(), {}
    raft_module.make_corr_lookup = recording
    try:
        for label, impl, budget in (("auto", "auto", None),
                                    ("hybrid", "hybrid", None),
                                    ("materialized", "auto", "1000000")):
            with restored_env():
                os.environ["PCFA_COMPUTE_DTYPE"] = "bfloat16"
                if budget is not None:
                    os.environ["PCFA_CORR_HBM_BUDGET_MB"] = budget
                loaded = load_model("RAFT", init_random=True, seed=0,
                                    corr_impl=impl)
                padder, flow_fn = make_flow_fn(loaded, hw, pad_mode="kitti")
                x1, x2 = padder.pad(*imgs)

                def closure():
                    a, b = (x.detach().requires_grad_() for x in (x1, x2))
                    flow = flow_fn(a, b)
                    (flow * g).sum().backward()
                    return flow, a, b

                times, taken[:] = [], []
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(2):
                    launches = (cl.corr_window_fwd.launches,
                                cl.corr_window_bwd.launches)
                    t = time.perf_counter()
                    flow, a, b = closure()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                launches = (cl.corr_window_fwd.launches - launches[0],
                            cl.corr_window_bwd.launches - launches[1])
                peak = torch.cuda.max_memory_allocated()
                if profile:
                    profile_step(closure, f"one closure through corr path "
                                 f"{label} at 2x KITTI", top=12)
                for what, v in (("flow", flow), ("d image1", a.grad),
                                ("d image2", b.grad)):
                    if not torch.isfinite(v).all():
                        raise AssertionError(f"corr path {label}: {what} "
                                             "not finite")
                if flow.shape != (pairs, *hw, 2) or len(set(taken)) != 1:
                    raise AssertionError(f"corr path {label}: flow "
                                         f"{tuple(flow.shape)}, paths "
                                         f"{taken}")
                res[label] = dict(path=taken[0], times=times, peak=peak,
                                  launches=launches, flow=flow.detach())
                del loaded, flow_fn, a, b, flow
                torch.cuda.empty_cache()
    finally:
        raft_module.make_corr_lookup = make_lookup

    shape = (pairs, padder.padded_shape[0] // 8, padder.padded_shape[1] // 8,
             256)
    want = resolve_corr_impl("auto", shape, shape, 4, torch.bfloat16)
    if not res["auto"]["path"] == want == "fused":
        raise AssertionError(f"corr_impl='auto' at 2x KITTI took "
                             f"{res['auto']['path']} (resolves to {want})")
    if res["materialized"]["path"] != "materialized":
        raise AssertionError("the budget knob did not force 'materialized'")
    ref = res["materialized"]["flow"]
    scale = float(ref.abs().max())
    for label in ("auto", "hybrid"):
        err = float((res[label]["flow"] - ref).abs().max())
        res[label]["err"] = err
        if not err <= 2e-2 * scale:
            raise AssertionError(f"corr path {label}: flow differs from "
                                 f"materialized by {err} (scale {scale})")
    pyr = sum((shape[1] >> i) * (shape[2] >> i) for i in range(4))
    est = 2 * pairs * shape[1] * shape[2] * pyr * 2
    log(f"# corr paths, RAFT 12 iters bf16 at {hw[0]}x{hw[1]} padded to "
        f"{padder.padded_shape}, {pairs} pairs (materialized estimate "
        f"{est / 2**30:.2f} GiB against the default 6 GiB budget): " +
        "; ".join(
            f"{label} -> {r['path']}: closure {1e3 * min(r['times']):.1f} ms "
            f"(runs {[round(1e3 * t, 1) for t in r['times']]}), peak "
            f"{r['peak'] / 2**30:.2f} GiB, lookup kernel launches fwd/bwd "
            f"{r['launches'][0]}/{r['launches'][1]} per closure"
            + (f", flow vs materialized max abs {r['err']:.3g}"
               if "err" in r else f", flow scale {scale:.3g}")
            for label, r in res.items()) + f" [{card}]")
    return res


# ------------------------------------------------------------------ 8 ---

def phase_checkpoint():
    """Checkpoints in the reference's shipped layouts, written here, loaded
    by `load_model(checkpoint=...)` on the card, each held against the
    same file loaded on the CPU by one forward (128×128, 2 pairs,
    float32, rtol/atol 1e-3):
    * RAFT: a random state of the port's RAFT (seed 1) with every
      BatchNorm expanded to weight, bias, running mean, running variance
      (positive) and `num_batches_tracked`, every key prefixed `module.`
      (DataParallel), written with `torch.save`, 3 iterations; its folded
      BatchNorms must equal the fold computed here;
    * RAFT-small: a random state (seed 3), keys prefixed `module.`, 3
      iterations;
    * SpyNet: a directory of per-layer files
      `modelL{level}_F-{conv}-{weight,bias}.pth.tar` (seed 4), 6 levels;
    * FlowNet2: a random state (seed 6, biases drawn too) wrapped as
      `{'state_dict': …}` in a `.pth.tar` of ≈ 650 MB.
    Flow-head conv2s are damped ×0.01, as the parity phase does."""
    import tempfile

    from pcfa_tpu_torch.models import make_model
    from pcfa_tpu_torch.runtime import init_random_, load_model

    gen = torch.Generator().manual_seed(2)
    sd = {}
    for k, v in init_random_(make_model("RAFT")[0], 1).state_dict().items():
        if k.endswith(".scale"):
            stem, c = k.removesuffix(".scale"), v.shape
            sd[f"{stem}.weight"] = 1.0 + 0.2 * torch.randn(c, generator=gen)
            sd[f"{stem}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
            sd[f"{stem}.running_var"] = 0.5 + torch.rand(c, generator=gen)
            sd[f"{stem}.num_batches_tracked"] = torch.tensor(1000)
        else:
            sd[k] = v
    small = dict(init_random_(make_model("RAFT-small")[0], 3).state_dict())
    for state in (sd, small):
        for p in ("weight", "bias"):
            state[f"update_block.flow_head.conv2.{p}"] = (
                0.01 * state[f"update_block.flow_head.conv2.{p}"])
    spy = init_random_(make_model("SpyNet")[0], 4).state_dict()
    fn2 = dict(init_random_(make_model("FlowNet2")[0], 6).state_dict())
    for k, v in fn2.items():
        if k.endswith(".bias"):
            fn2[k] = 0.05 * torch.randn(v.shape, generator=gen)
    rng = np.random.default_rng(5)
    x1, x2 = (torch.from_numpy(rng.random((2, 128, 128, 3))
                               .astype(np.float32)) for _ in range(2))
    with tempfile.TemporaryDirectory() as d:
        files = {"RAFT": os.path.join(d, "raft-sintel.pth"),
                 "RAFT-small": os.path.join(d, "raft-small.pth"),
                 "SpyNet": os.path.join(d, "spynet_weights"),
                 "FlowNet2": os.path.join(d, "FlowNet2_checkpoint.pth.tar")}
        for name, state in (("RAFT", sd), ("RAFT-small", small)):
            torch.save({f"module.{k}": v for k, v in state.items()},
                       files[name])
        torch.save({"state_dict": fn2}, files["FlowNet2"])
        fn2_mb = os.path.getsize(files["FlowNet2"]) / 2**20
        os.makedirs(files["SpyNet"])
        for lvl in range(6):
            for j in range(5):
                for p in ("weight", "bias"):
                    torch.save(spy[f"moduleBasic.{lvl}.moduleBasic."
                                   f"{2 * j}.{p}"],
                               os.path.join(files["SpyNet"], f"modelL"
                                            f"{lvl + 1}_F-{j + 1}-{p}"
                                            ".pth.tar"))
        for name, path in files.items():
            kw = {} if name in ("SpyNet", "FlowNet2") else {"iters": 3}
            t = time.perf_counter()
            card = load_model(name, checkpoint=path, **kw)
            t_load = time.perf_counter() - t
            cpu = load_model(name, checkpoint=path, device="cpu", **kw)
            got = card.module.state_dict()
            if name == "RAFT":
                stem = "cnet.layer1.0.norm1"
                scale = sd[f"{stem}.weight"] / torch.sqrt(
                    sd[f"{stem}.running_var"] + 1e-5)
                same = (torch.equal(got[f"{stem}.scale"].cpu(), scale)
                        and torch.equal(got["fnet.conv1.weight"].cpu(),
                                        sd["fnet.conv1.weight"]))
            else:
                want = {"RAFT-small": small, "SpyNet": spy,
                        "FlowNet2": fn2}[name]
                same = all(torch.equal(got[k].cpu(), v)
                           for k, v in want.items())
            if not same:
                raise AssertionError(f"checkpoint {name}: loaded weights "
                                     "differ from the file's")
            with torch.no_grad():
                up = card.module(x1.cuda(), x2.cuda())
                ref = cpu.module(x1, x2)
            up, ref = ((o[-1] if isinstance(o, tuple) else o) for o in (up,
                                                                        ref))
            up = up.cpu()
            err = float((up - ref).abs().max())
            if not (torch.isfinite(up).all()
                    and torch.allclose(up, ref, rtol=1e-3, atol=1e-3)):
                raise AssertionError(f"checkpoint {name}: card flow differs "
                                     f"from CPU's by {err}")
            size = f", {fn2_mb:.0f} MiB" if name == "FlowNet2" else ""
            log(f"# checkpoint: {name} from a shipped-layout "
                f"{'directory' if name == 'SpyNet' else 'file'} "
                f"({len(got)} tensors{size}), loaded on the card in "
                f"{t_load:.2f} s;"
                f" forward 128x128 card vs CPU max abs err {err:.3g} (scale "
                f"{float(ref.abs().max()):.3g})")


# ------------------------------------------------------------------ 9 ---

def phase_other_attacks(pairs: int = PAIRS) -> dict:
    """The I-FGSM and universal attacks on full SpyNet (6 levels, random
    weights from seed 0) at 375×1242 padded to 384×1280, `pairs` random
    pairs per batch, from the entry points a user calls, in the caller's
    environment (main() gives SpyNet's: bf16 network, compact L-BFGS with
    a bf16 history): I-FGSM 2 steps (ε 0.00025, zero target, AEE); the
    universal attack on two batches, 1 step × max_iter 2 each, history
    100, δ-bound 0.005 with the PCFA mu for a zero target, the L-BFGS
    state carried from the first batch to the second. Checks finite
    metrics of the right shapes, that the history count grew across the
    batches and that both attacks launched the small conv (forward and
    dx) and the warp's backward; prints times and launches."""
    from pcfa_tpu_torch import config
    from pcfa_tpu_torch.attack import fgsm, universal
    from pcfa_tpu_torch.attack.losses import default_mu
    from pcfa_tpu_torch.runtime import load_model, make_flow_fn

    loaded = load_model("SpyNet", init_random=True, seed=0)
    padder, flow_fn = make_flow_fn(loaded, KITTI_HW, pad_mode="kitti")
    rng = np.random.default_rng(7)
    batches = [padder.pad(*(torch.from_numpy(rng.random(
        (pairs, *KITTI_HW, 3)).astype(np.float32)).cuda() for _ in range(2)))
        for _ in range(2)]
    target = torch.zeros((pairs, *KITTI_HW, 2), device="cuda")
    names = ("small_conv_fwd", "small_conv_dx", "warp_bwd")
    wrappers = {n: wrapper(n) for n in names}
    card, res = card_line(), {}

    def run(label, fn):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {n: w.launches for n, w in wrappers.items()}
        missing = [n for n, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"{label} never launched {missing}")
        res[label] = dict(seconds=secs, launches=launches)
        return out

    fcfg = fgsm.FGSMConfig(steps=2)
    fres = run("I-FGSM", lambda: fgsm.fgsm_attack(
        flow_fn, *batches[0], target, fcfg))
    ucfg = universal.UniversalConfig(
        steps=1, max_iter=2, delta_bound=0.005,
        mu=default_mu(0.005, "zero"),
        lbfgs_direction=config.lbfgs_direction(),
        lbfgs_history_dtype=config.lbfgs_history_dtype("SpyNet"))
    state = universal.universal_init((*padder.padded_shape, 3), ucfg)
    counts, umetrics = [], []

    def universal_run():
        nonlocal state
        for images1, images2 in batches:
            state, m, _, pred = universal.universal_batch_attack(
                flow_fn, images1, images2, target, state, ucfg)
            counts.append(int(state.count[0]))
            umetrics.append(m)
        return pred

    upred = run("universal", universal_run)
    for label, metrics, shape in (
            ("I-FGSM", fres.metrics, (pairs, fcfg.steps)),
            *((f"universal batch {i}", m, (ucfg.steps,))
              for i, m in enumerate(umetrics))):
        for name, v in metrics._asdict().items():
            if v.shape != shape or not torch.isfinite(v).all():
                raise AssertionError(f"{label}: metric {name} {v}")
    for what, v in (("I-FGSM flow", fres.flow_pred), ("universal flow",
                                                        upred)):
        if v.shape != (pairs, *KITTI_HW, 2) or not torch.isfinite(v).all():
            raise AssertionError(f"{what}: {tuple(v.shape)}, not finite")
    if not counts[1] > counts[0] >= 1:
        raise AssertionError(f"universal: history counts {counts} did not "
                             "grow across the batches")
    log(f"# other attacks, SpyNet 6 levels at {padder.padded_shape}, "
        f"{pairs} pairs, compute {os.environ.get('PCFA_COMPUTE_DTYPE')}: "
        f"I-FGSM {fcfg.steps} steps in {res['I-FGSM']['seconds']:.3f} s, "
        f"aee_adv_tgt per step {fres.metrics.aee_adv_tgt.tolist()}, "
        f"launches {json.dumps(res['I-FGSM']['launches'])}; universal "
        f"2 batches x {ucfg.steps} step x max_iter {ucfg.max_iter} in "
        f"{res['universal']['seconds']:.3f} s, history count after each "
        f"batch {counts}, aee_adv_tgt "
        f"{[m.aee_adv_tgt.tolist() for m in umetrics]}, l2_delta12 "
        f"{[m.l2_delta12.tolist() for m in umetrics]}, launches "
        f"{json.dumps(res['universal']['launches'])} [{card}]")
    return res


# ----------------------------------------------------------------- 10 ---

# phase 10's CLI runs: (net whose kernel rows apply, kernels it must launch)
CLI_RUNS = {
    "cli attack_pcfa RAFT": ("RAFT", PATH_KERNELS["RAFT"]),
    "cli attack_pcfa SpyNet universal": ("SpyNet", PATH_KERNELS["SpyNet"]),
    "cli evaluate_pcfa RAFT": ("RAFT", ["corr_lookup_fwd",
                                        "small_conv_fwd"]),
    "cli attack_fgsm PWCNet": ("PWCNet", PATH_KERNELS["PWCNet"]),
}
CLI_STEPS = 20    # the published attack's outer steps
CLI_STEP_KEYS = ("batch", "steps", "epoch", "aee_predadv-tgt",
                 "aee_pred-predadv", "l2_delta1", "l2_delta2", "l2_delta-avg",
                 "aee_pred-tgt_min", "l2_delta-avg_min",
                 "aee_pred-predadv_min")


def _cli_run_folder(out: str) -> str:
    import glob

    runs = glob.glob(os.path.join(out, "*", "*"))
    if len(runs) != 1:
        raise AssertionError(f"expected one run folder under {out}: {runs}")
    return runs[0]


def _cli_metrics(run: str) -> list[dict]:
    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    bad = [m for m in metrics if not math.isfinite(m["value"])]
    if not metrics or bad:
        raise AssertionError(f"{run}: metrics empty or not finite: {bad}")
    return metrics


def _png_size(path: str) -> tuple[int, int]:
    """(width, height) from a PNG's header; raises if it is not a PNG."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return tuple(int.from_bytes(head[i:i + 4], "big") for i in (16, 20))


@contextlib.contextmanager
def spans(*targets):
    """Replace each `(module, function name)` with a wrapper that times its
    calls on a `StepTimer` of that name (fenced before the call too, so
    that work queued earlier is not charged to it); yields {name: timer},
    and the originals are back when the block ends."""
    from pcfa_tpu_torch.utils.profiling import StepTimer, fence

    timers, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)
        timers[name] = StepTimer()

        def timed(*args, _fn=fn, _timer=timers[name], **kw):
            fence()
            return _timer.fenced(functools.partial(_fn, *args, **kw))

        setattr(mod, name, timed)
        saved.append((mod, name, fn))
    try:
        yield timers
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_clis() -> dict:
    """The three CLIs as a user runs them, each `main(argv, device="cuda")`
    called in this process in its net's main-path environment, on
    Synthetic frames of KITTI's size (PCFA_SYNTHETIC_SIZE=375x1242,
    training stage), random weights (the CLIs' fallback: no checkpoint is
    on the machine), output in a temporary folder:
    1. RAFT, `attack_pcfa` at the published config: 2 pairs in one call,
       20 steps × L-BFGS max_iter 10, δ-bound 0.005, zero target,
       clipping; every per-step metric logged 20 × 2 times and finite, the
       best δ's norm under the bound (×(1 + 1e-3)), `00000_delta1_best.npy`
       of shape (1, 3, 376, 1248), the PNGs; wall time, pairs/s, peak,
       and the time in the model's load, the flow function's set-up, the
       engine and the artifact writer (`spans`);
    2. SpyNet, `attack_pcfa --universal_perturbation`, batch 2, 1 epoch,
       1 step, 4 frames (2 batches): `*_delta1_e0.npy` written;
    3. RAFT, `evaluate_pcfa` of run 2's δ (SpyNet's ÷64 padding converted
       to RAFT's ÷8): finite metrics;
    4. PWCNet, `attack_fgsm`, 2 steps, 1 pair;
    5. one subprocess, `python3 -m pcfa_tpu_torch.cli.evaluate_pcfa`, on
       run 2's folder with SpyNet: exit 0 and its metrics file.
    Each of runs 1–4 must launch the kernels `CLI_RUNS` names (counts set
    to 0 just before the run, read just after). Returns per run its
    seconds, launches and peak memory."""
    import importlib.util
    import tempfile

    from pcfa_tpu_torch.cli import (attack_fgsm, attack_pcfa, common,
                                    evaluate_pcfa)

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "cv2", "tqdm", "matplotlib", "mlflow")}
    log(f"# clis: importable here: {json.dumps(have)}")
    wrappers = {name: wrapper(name) for name, *_ in KERNELS}
    data = ["--dataset=Synthetic", "--dataset_stage=training",
            "--unregistered_artifacts"]
    res = {}

    def run(label, count, main, argv):
        net = CLI_RUNS[label][0]
        os.environ["PCFA_SYNTHETIC_COUNT"] = str(count)
        with main_path_env(net):
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = main([f"--net={net}", *data, *argv], device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        launches = {n: w.launches for n, w in wrappers.items()}
        missing = [k for k in CLI_RUNS[label][1] if launches[k] == 0]
        if missing:
            raise AssertionError(f"{label} never launched {missing}")
        res[label] = dict(seconds=secs, launches=launches,
                          peak=torch.cuda.max_memory_allocated())
        log(f"# {label}: {secs:.3f} s, peak "
            f"{res[label]['peak'] / 2**30:.2f} GiB, launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})} "
            f"[{card_line()}]")
        return out

    with tempfile.TemporaryDirectory(prefix="pcfa_clis_") as tmp, \
            restored_env():
        os.environ["PCFA_SYNTHETIC_SIZE"] = f"{KITTI_HW[0]}x{KITTI_HW[1]}"
        os.environ["PCFA_NO_MLFLOW"] = "1"

        # 1. RAFT's published attack
        label = "cli attack_pcfa RAFT"
        out = os.path.join(tmp, "raft")
        with spans((common, "load_attack_model"),
                   (attack_pcfa, "make_flow_fn"),
                   (attack_pcfa, "pcfa_attack"),
                   (attack_pcfa, "_save_pair")) as where:
            run(label, 2, attack_pcfa.main, [
                "--pairs_per_device=2", f"--steps={CLI_STEPS}",
                "--boxconstraint=clipping", "--delta_bound=0.005",
                "--target=zero", f"--output_folder={out}"])
        folder = _cli_run_folder(out)
        metrics = _cli_metrics(folder)
        for key in CLI_STEP_KEYS:
            steps = [m["step"] for m in metrics if m["key"] == key]
            if steps != list(range(2 * CLI_STEPS)):
                raise AssertionError(f"{label}: {key} logged at {steps}")
        l2_min = [m["value"] for m in metrics
                  if m["key"] == "l2_delta-avg_min"]
        last = (CLI_STEPS - 1, 2 * CLI_STEPS - 1)    # each pair's last step
        l2_min = [l2_min[i] for i in last]
        if max(l2_min) > 0.005 * (1 + 1e-3):
            raise AssertionError(f"{label}: best δ norms {l2_min} over the "
                                 "bound")
        patches = os.path.join(folder, "patches")
        padded = tuple(-(-d // 8) * 8 for d in KITTI_HW)    # 376×1248
        d1 = np.load(os.path.join(patches, "00000_delta1_best.npy"))
        if d1.shape != (1, 3, *padded) or not np.isfinite(d1).all():
            raise AssertionError(f"{label}: delta1_best {d1.shape}")
        for pair in (0, 1):
            for name in ("image1", "image2", "image1_delta_best",
                         "image2_delta_best", "delta1_best", "delta2_best",
                         "flow_pred_best", "flow_pred_init", "flow_target",
                         "flow_gt"):
                size = _png_size(os.path.join(patches,
                                              f"{pair:05d}_{name}.png"))
                want = padded if "image" in name or "delta" in name \
                    else KITTI_HW
                want = (want[1], want[0])
                if size != want:
                    raise AssertionError(f"{label}: {name}.png {size}")
        secs = res[label]["seconds"]
        aee_min = [m["value"] for m in metrics
                   if m["key"] == "aee_pred-predadv_min"]
        log(f"# {label}: published config ({CLI_STEPS} steps × max_iter 10, "
            f"2 pairs, bf16 network and history) in {secs:.3f} s of wall = "
            f"{2 / secs:.5f} pairs/s (a run, model load and artifacts "
            f"included); best δ norms {l2_min}, their aee_pred-predadv "
            f"{[aee_min[i] for i in last]}; peak "
            f"{res[label]['peak'] / 2**30:.2f} GiB; seconds in "
            f"{json.dumps({k: round(t.total, 3) for k, t in where.items()})}"
            f", the rest {secs - sum(t.total for t in where.values()):.3f} "
            f"[{card_line()}]")
        torch.cuda.empty_cache()

        # 2. SpyNet's universal attack
        label = "cli attack_pcfa SpyNet universal"
        uni = run(label, 4, attack_pcfa.main, [
            "--universal_perturbation", "--batch_size=2", "--epochs=1",
            "--steps=1", f"--output_folder={os.path.join(tmp, 'uni')}"])
        uni = uni["folder_path"]
        _cli_metrics(uni)
        if not os.path.exists(os.path.join(uni, "patches",
                                           "00001_delta1_e0.npy")):
            raise AssertionError(f"{label}: no 00001_delta1_e0.npy")

        # 3. RAFT evaluates SpyNet's δ
        label = "cli evaluate_pcfa RAFT"
        out = os.path.join(tmp, "eval")
        ev = run(label, 4, evaluate_pcfa.main, [
            "--origin_net=SpyNet", "--universal_perturbation",
            f"--perturbation_sourcefolder={uni}", f"--output_folder={out}"])
        _cli_metrics(_cli_run_folder(out))
        if not all(math.isfinite(v) for v in ev[0].values()):
            raise AssertionError(f"{label}: {ev}")
        log(f"# {label} of the SpyNet δ: {json.dumps(ev[0])}")

        # 4. PWCNet's I-FGSM
        label = "cli attack_fgsm PWCNet"
        out = os.path.join(tmp, "fgsm")
        avgs = run(label, 1, attack_fgsm.main,
                   ["--steps=2", f"--output_folder={out}"])
        _cli_metrics(_cli_run_folder(out))
        log(f"# {label}: averages {json.dumps(avgs)}")

        # 5. the evaluator as a module, in its own process
        out = os.path.join(tmp, "sub")
        os.environ["PCFA_SYNTHETIC_COUNT"] = "4"
        t = time.perf_counter()
        with main_path_env("SpyNet"):
            proc = subprocess.run(
                [sys.executable, "-m", "pcfa_tpu_torch.cli.evaluate_pcfa",
                 "--net=SpyNet", *data, "--origin_net=SpyNet",
                 "--universal_perturbation", "--batch_size=2",
                 f"--perturbation_sourcefolder={uni}",
                 f"--output_folder={out}"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(
                f"python3 -m pcfa_tpu_torch.cli.evaluate_pcfa exited "
                f"{proc.returncode}: {proc.stderr[-2000:]}")
        sub = _cli_metrics(_cli_run_folder(out))
        log(f"# python3 -m pcfa_tpu_torch.cli.evaluate_pcfa (SpyNet, run "
            f"2's δ): exit 0 in {time.perf_counter() - t:.1f} s, "
            f"{len(sub)} metrics")
    return res


# ----------------------------------------------------------------- 11 ---

# phase 11's runs, each on two ranks of the one card: (net whose kernel
# rows apply, kernels each rank must launch)
RANK_RUNS = {
    "ranks J.1 RAFT pair-parallel": ("RAFT", PATH_KERNELS["RAFT"]),
    "ranks J.2 SpyNet universal": ("SpyNet", PATH_KERNELS["SpyNet"]),
    "ranks J.3 row-sharded RAFT and GMA": ("RAFT", PATH_KERNELS["RAFT"]),
}
RANKS = 2
RANK_TIMEOUT_S = 600
SP_RAFT_HW = (752, 2488)   # 2× KITTI 750×2484 padded to ÷8: H/8 = 94
SP_GMA_HW = (384, 1248)
FIRST_CLOSURE_TOL = 1e-4


def rel_err(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).norm() / ref.norm())


def j1_setup(loaded):
    """RAFT's pairs of phase 11 (2, seed 11, KITTI) padded, a zero target,
    and the attack's config in the current environment."""
    from pcfa_tpu_torch import config
    from pcfa_tpu_torch.attack import pcfa
    from pcfa_tpu_torch.runtime import make_flow_fn

    padder, flow_fn = make_flow_fn(loaded, KITTI_HW, pad_mode="kitti")
    rng = np.random.default_rng(11)
    imgs = [torch.from_numpy(rng.random((RANKS, *KITTI_HW, 3))
                             .astype(np.float32)).cuda() for _ in range(2)]
    cfg = pcfa.PCFAConfig(
        steps=2, max_iter=2, delta_bound=0.005, loss="aee", target="zero",
        boxconstraint="clipping", history_size=100,
        lbfgs_direction=config.lbfgs_direction(),
        lbfgs_history_dtype=config.lbfgs_history_dtype("RAFT"))
    target = torch.zeros((RANKS, *KITTI_HW, 2), device="cuda")
    return flow_fn, *padder.pad(*imgs), target, cfg


def j2_setup(loaded):
    """SpyNet's flow function, padder and batches of phase 11 (2 of 2
    pairs, seed 12, KITTI padded to 384×1280), and a zero target of one
    pair, in the current environment."""
    from pcfa_tpu_torch.runtime import make_flow_fn

    padder, flow_fn = make_flow_fn(loaded, KITTI_HW, pad_mode="kitti")
    rng = np.random.default_rng(12)
    batches = [padder.pad(*(torch.from_numpy(rng.random(
        (RANKS, *KITTI_HW, 3)).astype(np.float32)).cuda() for _ in range(2)))
        for _ in range(2)]
    return flow_fn, padder, batches, torch.zeros((1, *KITTI_HW, 2),
                                                 device="cuda")


def ucfg(max_iter: int):
    """Phase 11's universal config, 1 step × `max_iter`, in the current
    environment."""
    from pcfa_tpu_torch import config
    from pcfa_tpu_torch.attack import universal
    from pcfa_tpu_torch.attack.losses import default_mu

    return universal.UniversalConfig(
        steps=1, max_iter=max_iter, delta_bound=0.005,
        mu=default_mu(0.005, "zero"),
        lbfgs_direction=config.lbfgs_direction(),
        lbfgs_history_dtype=config.lbfgs_history_dtype("SpyNet"))


@contextlib.contextmanager
def first_closure(captured: list):
    """Records (value, gradient) of the first closure the universal
    engine's L-BFGS calls, by calling it once more."""
    from pcfa_tpu_torch.attack import universal

    orig = universal.lbfgs_iteration

    def spy(value_and_grad, state, pos, **kw):
        if not captured:
            captured.append(value_and_grad(state.x))
        return orig(value_and_grad, state, pos, **kw)

    universal.lbfgs_iteration = spy
    try:
        yield captured
    finally:
        universal.lbfgs_iteration = orig


def sp_inputs(hw, seed):
    rng = np.random.default_rng(seed)
    x1, x2 = (torch.from_numpy(rng.random((1, *hw, 3)).astype(np.float32))
              .cuda() for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((1, *hw, 2))
                         .astype(np.float32)).cuda()
    return x1, x2, g


def sp_model(net, shards):
    from pcfa_tpu_torch.runtime import load_model

    extra = dict(corr_impl="materialized") if net == "RAFT" else {}
    return damped(load_model(net, init_random=True, seed=0,
                             spatial_shards=shards, **extra),
                  gamma=0.5 if net == "GMA" else None)


def sp_closure(flow_fn, x1, x2, g):
    """flow_up and the input gradients of Σ flow_up·g (on the CPU); the
    seconds; the closure's own peak memory (above what was allocated
    before it: weights and inputs)."""
    a, b = (x.detach().requires_grad_(True) for x in (x1, x2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    up = flow_fn(a, b)
    (up * g).sum().backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    return ([v.detach().cpu() for v in (up, a.grad, b.grad)], secs,
            torch.cuda.max_memory_allocated() - base)


@contextlib.contextmanager
def float32_env():
    """A float32 network and L-BFGS history, under the caller's
    environment otherwise."""
    with restored_env():
        os.environ.pop("PCFA_COMPUTE_DTYPE", None)
        os.environ.pop("PCFA_LBFGS_DTYPE", None)
        yield


def rank_references(folder: str) -> tuple[dict, dict]:
    """What phase 11's ranks are held against, from this one process on
    the card in float32 ('highest'), saved to `folder`:

    * the first closure of the RAFT attack (value, δ-gradient) of each
      pair alone, and of the 2 pairs as one batch;
    * the first closure of the universal SpyNet attack (value, gradient)
      on each pair alone, and on the 2 pairs as one batch;
    * the unsplit RAFT (2× KITTI, materialized) and GMA (384×1248)
      closures with their times and peaks.

    Batch size alone moves a float32 gradient: cuDNN and cuBLAS round a
    batch of 2 otherwise than a batch of 1, which switches ReLU units of a
    random RAFT on or off (the 2-pair closure's gradient lay 1.2e-3 and
    2.1e-3 (rel L2) from the ranks' 1-pair ones, whose values agreed to
    1.2e-7). So a rank, which runs 1 pair, is held to the pairs alone at
    `FIRST_CLOSURE_TOL`, and its distance to the batch is printed beside
    the batch's own to the pairs alone. Returns the closures' peaks and
    those distances."""
    from pcfa_tpu_torch.attack import pcfa, universal
    from pcfa_tpu_torch.runtime import load_model

    def j1_closure(flow_fn, x1, x2, target, cfg):
        x0, _, _, value_and_grad = pcfa._make_problem(flow_fn, x1, x2,
                                                      target, cfg)
        return value_and_grad(x0)

    def j2_closure(flow_fn, images1, images2, target, padder):
        cfg = ucfg(1)
        with first_closure([]) as got:
            universal.universal_batch_attack(
                flow_fn, images1, images2,
                target.expand(images1.shape[0], -1, -1, -1),
                universal.universal_init((*padder.padded_shape, 3), cfg),
                cfg)
        return got[0]

    floor = {}
    with float32_env():
        loaded = load_model("RAFT", init_random=True, seed=0)
        flow_fn, x1, x2, target, cfg = j1_setup(loaded)
        batch = j1_closure(flow_fn, x1, x2, target, cfg)
        pairs = [j1_closure(flow_fn, x1[p:p + 1], x2[p:p + 1],
                            target[p:p + 1], cfg) for p in range(RANKS)]
        ref = dict(batch_loss=batch[0].cpu(), batch_grad=batch[1].cpu(),
                   pair_loss=torch.cat([v for v, _ in pairs]).cpu(),
                   pair_grad=torch.cat([g for _, g in pairs]).cpu())
        floor["J.1"] = [rel_err(ref["pair_grad"][p], ref["batch_grad"][p])
                        for p in range(RANKS)]
        torch.save(ref, os.path.join(folder, "j1_ref.pt"))

        loaded = load_model("SpyNet", init_random=True, seed=0)
        flow_fn, padder, batches, target = j2_setup(loaded)
        b1, b2 = batches[0]
        batch = j2_closure(flow_fn, b1, b2, target, padder)
        pairs = [j2_closure(flow_fn, b1[p:p + 1], b2[p:p + 1], target,
                            padder) for p in range(RANKS)]
        # at δ = 0 the penalty and its gradient are 0, and each pair has as
        # many pixels: the global value and gradient are the pairs' means
        ref = dict(batch_loss=batch[0].cpu(), batch_grad=batch[1].cpu(),
                   pair_loss=sum(v for v, _ in pairs).cpu() / RANKS,
                   pair_grad=sum(g for _, g in pairs).cpu() / RANKS)
        floor["J.2"] = [rel_err(ref["pair_grad"], ref["batch_grad"])]
        torch.save(ref, os.path.join(folder, "j2_ref.pt"))
        del loaded, flow_fn, batches
        peaks = {}
        for net, hw, seed in (("RAFT", SP_RAFT_HW, 13),
                              ("GMA", SP_GMA_HW, 14)):
            model = sp_model(net, 1)
            out, secs, peak = sp_closure(lambda a, b: model(a, b)[1],
                                         *sp_inputs(hw, seed))
            torch.save(out, os.path.join(folder, f"j3_{net}_ref.pt"))
            peaks[net] = dict(seconds=secs, peak=peak)
            del model
            torch.cuda.empty_cache()
    return peaks, floor


def rank_worker(folder: str) -> None:
    """One rank of phase 11 (`python3 chip_smoke.py --rank <folder>`, with
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK set): joins
    the group (`multihost.initialize`), runs J.1, J.2 and J.3 in turn and
    writes `<folder>/rank<r>.json`; raises on any failed check."""
    import torch.distributed as dist

    from pcfa_tpu_torch.attack import pcfa, universal
    from pcfa_tpu_torch.config import RuntimeConfig
    from pcfa_tpu_torch.parallel import (data_mesh, dp, multihost,
                                         pcfa_attack_dp, space_mesh,
                                         spatial_flow_fn,
                                         universal_batch_attack_dp)
    from pcfa_tpu_torch.parallel.mesh import all_gather_cat
    from pcfa_tpu_torch.runtime import load_model
    from pcfa_tpu_torch._device import resolve_device

    multihost.initialize()
    resolve_device("cuda")
    RuntimeConfig("highest").apply()
    mesh = data_mesh()
    r = mesh.rank
    card = card_line()
    wrappers = {name: wrapper(name) for name, *_ in KERNELS}
    report = {"rank": r, "backend": mesh.backend, "runs": {}}

    def counted(label, fn):
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {n: w.launches for n, w in wrappers.items()}
        missing = [k for k in RANK_RUNS[label][1] if launches[k] == 0]
        if missing:
            raise AssertionError(f"rank {r}: {label} never launched "
                                 f"{missing}")
        report["runs"][label] = dict(
            seconds=secs, peak=torch.cuda.max_memory_allocated(),
            launches=launches)
        return out

    def finite(what, tensors):
        for t in tensors:
            if not torch.isfinite(t).all():
                raise AssertionError(f"rank {r}: {what} not finite")

    def close(what, loss, grad, ref, rows):
        """Value and gradient errors against the pairs alone (held to
        FIRST_CLOSURE_TOL) and the gradient's against the batch."""
        def value_err(key):
            want = ref[key][rows].double()
            return float((loss.double().cpu() - want).abs().max()
                         / want.abs().max())

        e_v, e_g = value_err("pair_loss"), rel_err(grad,
                                                   ref["pair_grad"][rows])
        if not (e_v <= FIRST_CLOSURE_TOL and e_g <= FIRST_CLOSURE_TOL):
            raise AssertionError(f"rank {r}: {what}: value rel err {e_v}, "
                                 f"gradient rel L2 {e_g}")
        return e_v, e_g, value_err("batch_loss"), rel_err(
            grad, ref["batch_grad"][rows])

    def close_line(errs):
        return (f"float32 first closure vs one process, the pairs alone: "
                f"value rel err {errs[0]:.3g}, gradient rel L2 "
                f"{errs[1]:.3g}; vs the 2 pairs as one batch: "
                f"{errs[2]:.3g}, {errs[3]:.3g}")

    # J.1: pair-parallel PCFA on RAFT, the main path's bf16 environment
    label = "ranks J.1 RAFT pair-parallel"
    with main_path_env("RAFT"):
        loaded = load_model("RAFT", init_random=True, seed=0)
        flow_fn, x1, x2, target, cfg = j1_setup(loaded)
        local = []
        attack = dp.pcfa_attack

        def spy(*args, **kw):
            local.append(attack(*args, **kw))
            return local[-1]

        dp.pcfa_attack = spy
        try:
            res = counted(label, lambda: pcfa_attack_dp(
                flow_fn, x1, x2, target, cfg, mesh))
        finally:
            dp.pcfa_attack = attack
    finite(label, pcfa_leaves(res))
    if res.delta1.shape != (RANKS, *x1.shape[1:]) or \
            res.flow_pred.shape != (RANKS, *KITTI_HW, 2) or \
            res.metrics.loss.shape != (RANKS, cfg.steps):
        raise AssertionError(f"rank {r}: {label}: gathered shapes "
                             f"{tuple(res.delta1.shape)}, "
                             f"{tuple(res.flow_pred.shape)}")
    for mine, gathered in zip(pcfa_leaves(local[0]), pcfa_leaves(res)):
        if not torch.equal(mine, gathered[r:r + 1]):
            raise AssertionError(f"rank {r}: {label}: its block of the "
                                 "gathered result differs from its own")
    with float32_env():
        flow32, *_ = j1_setup(loaded)
        x0, _, _, value_and_grad = pcfa._make_problem(
            flow32, x1[r:r + 1], x2[r:r + 1], target[r:r + 1], cfg)
        loss, grad = value_and_grad(x0)
    errs = close(label, loss, grad,
                 torch.load(os.path.join(folder, "j1_ref.pt")),
                 slice(r, r + 1))
    report["runs"][label]["first_closure_errs"] = errs
    run = report["runs"][label]
    log(f"# rank {r}/{RANKS} ({mesh.backend}): {label}, 1 pair per rank "
        f"of {RANKS} at {tuple(x1.shape[1:3])}, {cfg.steps} steps x "
        f"max_iter {cfg.max_iter}, bf16: {run['seconds']:.3f} s, peak "
        f"{run['peak'] / 2**30:.2f} GiB, aee_adv_tgt "
        f"{res.metrics.aee_adv_tgt[:, -1].tolist()}; {close_line(errs)}; "
        f"launches {json.dumps(nonzero(run['launches']))} [{card}]")
    del loaded, flow_fn, flow32, res, local
    torch.cuda.empty_cache()

    # J.2: the universal attack on SpyNet, one pair per rank
    label = "ranks J.2 SpyNet universal"
    with main_path_env("SpyNet"):
        loaded = load_model("SpyNet", init_random=True, seed=0)
        flow_fn, padder, batches, target = j2_setup(loaded)
        cfg = ucfg(2)
        state = universal.universal_init((*padder.padded_shape, 3), cfg)
        counts, metrics = [], []

        def run_batches():
            nonlocal state
            for b1, b2 in batches:
                state, m, _, pred = universal_batch_attack_dp(
                    flow_fn, b1[r:r + 1], b2[r:r + 1], target, state, cfg,
                    mesh)
                counts.append(int(state.count[0]))
                metrics.append(m)
            return pred

        pred = counted(label, run_batches)
    finite(label, [pred, state.x, *(v for m in metrics for v in m)])
    if not counts[1] > counts[0] >= 1:
        raise AssertionError(f"rank {r}: {label}: history counts {counts}")
    xs = all_gather_cat(state.x, mesh)
    if not all(torch.equal(xs[i], xs[0]) for i in range(RANKS)):
        raise AssertionError(f"rank {r}: {label}: the ranks' δ differ")
    with float32_env():
        flow32, *_ = j2_setup(loaded)
        cfg32 = ucfg(1)
        with first_closure([]) as got:
            universal_batch_attack_dp(
                flow32, batches[0][0][r:r + 1], batches[0][1][r:r + 1],
                target, universal.universal_init((*padder.padded_shape, 3),
                                                 cfg32), cfg32, mesh)
    errs = close(label, *got[0],
                 torch.load(os.path.join(folder, "j2_ref.pt")), slice(None))
    run = report["runs"][label]
    run["first_closure_errs"] = errs
    log(f"# rank {r}/{RANKS} ({mesh.backend}): {label}, 1 pair per rank, "
        f"2 batches x 1 step x max_iter 2 at {padder.padded_shape}, bf16: "
        f"{run['seconds']:.3f} s, peak {run['peak'] / 2**30:.2f} GiB, "
        f"history counts {counts}, δ bit-identical over the ranks; "
        f"{close_line(errs)}; launches "
        f"{json.dumps(nonzero(run['launches']))} [{card}]")
    del loaded, flow_fn, flow32, batches, state
    torch.cuda.empty_cache()

    # J.3: RAFT (2× KITTI, materialized) and GMA split by rows, float32
    label = "ranks J.3 row-sharded RAFT and GMA"
    smesh = space_mesh()
    rows = {}

    def closures():
        for net, hw, seed in (("RAFT", SP_RAFT_HW, 13),
                              ("GMA", SP_GMA_HW, 14)):
            model = sp_model(net, RANKS)
            out, secs, peak = sp_closure(spatial_flow_fn(model, smesh),
                                         *sp_inputs(hw, seed))
            ref = torch.load(os.path.join(folder, f"j3_{net}_ref.pt"))
            errs = []
            for what, got, want, tol in zip(
                    ("flow", "d image1", "d image2"), out, ref,
                    ((1e-4, 1e-4), (1e-3, 1e-6), (1e-3, 1e-6))):
                err = float((got - want).abs().max())
                errs.append((what, err, rel_err(got, want)))
                if not torch.allclose(got, want, rtol=tol[0], atol=tol[1]):
                    raise AssertionError(
                        f"rank {r}: {label}: {net} {what} max abs err {err}"
                        f" (rtol {tol[0]}, atol {tol[1]})")
            rows[net] = dict(seconds=secs, peak=peak, errs=errs)
            del model
            torch.cuda.empty_cache()

    with float32_env():
        counted(label, closures)
    report["runs"][label]["models"] = rows
    run = report["runs"][label]
    log(f"# rank {r}/{RANKS} ({mesh.backend}): {label}, float32, 1 pair, "
        f"{RANKS} row shards: " + "; ".join(
            f"{net} at {hw} {v['seconds']:.3f} s, peak "
            f"{v['peak'] / 2**30:.2f} GiB, vs unsplit: " + ", ".join(
                f"{w} max abs {e:.3g} (rel L2 {q:.3g})"
                for w, e, q in v["errs"])
            for (net, v), hw in zip(rows.items(), (SP_RAFT_HW, SP_GMA_HW)))
        + f"; launches {json.dumps(nonzero(run['launches']))} [{card}]")

    with open(os.path.join(folder, f"rank{r}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def pcfa_leaves(res) -> list:
    return [*res[:-1], *res.metrics]


def phase_ranks() -> dict:
    """Phase 11: slice J on two ranks of the one card, gloo (NCCL refuses
    two ranks on one card), one launch of `python3 chip_smoke.py --rank`
    per rank with the rank's environment; each rank runs J.1, J.2 and J.3
    (see `rank_worker`) against references this process computes first
    (`rank_references`). A rank that fails, or runs past RANK_TIMEOUT_S,
    fails the phase. Returns each run's launches, summed over the ranks.
    Two ranks on one card check correctness; the per-card rate is the
    one-process rate."""
    import socket
    import tempfile

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pcfa_ranks_") as folder:
        t = time.perf_counter()
        peaks, floor = rank_references(folder)
        t_refs = time.perf_counter() - t
        torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = []
        t = time.perf_counter()
        for r in range(RANKS):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE=str(RANKS),
                       RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(RANKS))
            with open(os.path.join(folder, f"rank{r}.log"), "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank",
                     folder], cwd=os.path.dirname(os.path.abspath(__file__)),
                    env=env, stdout=f, stderr=subprocess.STDOUT))
        failed = []
        try:
            for r, p in enumerate(procs):
                left = RANK_TIMEOUT_S - (time.perf_counter() - t)
                try:
                    p.wait(timeout=max(left, 1))
                except subprocess.TimeoutExpired:
                    failed.append(f"rank {r} ran past {RANK_TIMEOUT_S} s")
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        for r, p in enumerate(procs):
            with open(os.path.join(folder, f"rank{r}.log")) as f:
                out = f.read()
            for line in out.splitlines():
                if line.startswith("# ") or line.startswith("pcfa_tpu_torch"):
                    log(line)
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n"
                              f"{out[-3000:]}")
        if failed:
            raise AssertionError("phase 11: " + "\n".join(failed))
        reports = []
        for r in range(RANKS):
            with open(os.path.join(folder, f"rank{r}.json")) as f:
                reports.append(json.load(f))

    label = "ranks J.3 row-sharded RAFT and GMA"
    shape = (1, SP_RAFT_HW[0] // 8, SP_RAFT_HW[1] // 8)
    pyr = sum((shape[1] >> i) * (shape[2] >> i) for i in range(4))
    # one copy of the float32 pyramid is live at the closure's peak (its
    # values in the forward, or its gradient buffers in the backward); a
    # rank holds half of it
    pyr_bytes = shape[1] * shape[2] * pyr * 4
    falls = [peaks["RAFT"]["peak"]
             - rep["runs"][label]["models"]["RAFT"]["peak"]
             for rep in reports]
    if not all(0.8 <= f / (pyr_bytes / 2) <= 1.2 for f in falls):
        raise AssertionError(
            f"phase 11: the row-sharded RAFT's peak fell by "
            f"{[f / 2**30 for f in falls]} GiB, not about half its "
            f"pyramid's {pyr_bytes / 2**30:.2f} GiB")
    log(f"# phase 11: float32 first closures in one process, the 2 pairs "
        f"as one batch vs each pair alone, gradient rel L2: "
        f"{json.dumps(floor)} [{card_line()}]")
    log(f"# phase 11: references {t_refs:.1f} s, {RANKS} ranks "
        f"({reports[0]['backend']}) {wall:.1f} s of wall; unsplit closures "
        f"(float32, 1 pair): " + ", ".join(
            f"{net} {v['seconds']:.3f} s, peak {v['peak'] / 2**30:.2f} GiB"
            for net, v in peaks.items()) + f"; RAFT's materialized pyramid "
        f"{pyr_bytes / 2**30:.2f} GiB, the ranks' peaks "
        f"fell by {[round(f / 2**30, 2) for f in falls]} GiB; per-card "
        f"rate unchanged (two ranks share one card) [{card_line()}]")
    return {label: {k: sum(rep["runs"][label]["launches"][k]
                           for rep in reports)
                    for k in reports[0]["runs"][label]["launches"]}
            for label in RANK_RUNS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import pcfa_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pcfa_tpu_torch._device import resolve_device
    from pcfa_tpu_torch.config import RuntimeConfig

    resolve_device("cuda")
    # float32 means float32 on the card: the float32 phases compare with
    # TF32 off
    RuntimeConfig("highest").apply()
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on (PCFA_MATMUL_PRECISION="
                             f"{os.environ.get('PCFA_MATMUL_PRECISION')}); "
                             "the float32 checks need 'highest'")
    profile = "--profile" in sys.argv[1:]
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    by_path = {}
    for net, pairs in (("RAFT", PAIRS), ("GMA", PAIRS),
                       ("RAFT-small", PAIRS), ("SpyNet", PAIRS),
                       ("PWCNet", PWC_PAIRS), ("FlowNet2", FN2_PAIRS)):
        with main_path_env(net):
            by_path[net] = phase_main_path(net, pairs, profile)
        torch.cuda.empty_cache()
    phase_corr_paths(profile=profile)
    phase_checkpoint()
    with main_path_env("SpyNet"):
        phase_other_attacks()
    torch.cuda.empty_cache()
    for label, n in phase_clis().items():
        by_path[label] = n["launches"]
    by_path.update(phase_ranks())

    kernels = []
    keys = ("shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "timed")
    for name, _, _, src, replaces in KERNELS:
        # per path, the row at its main-path dtype (bf16) with the
        # largest bound; the top-level numbers are those of the
        # path that launched the kernel most. Every row is printed above.
        paths = {}
        for net, n in by_path.items():
            runs = {**CLI_RUNS, **RANK_RUNS}
            kernels_of, rows_of = (runs[net][1], runs[net][0]) \
                if net in runs else (PATH_KERNELS[net],
                                     ROW_PATH.get(net, net))
            if name in kernels_of:
                cand = [r for r in rows if r["name"] == name
                        and r["path"] == rows_of]
                r = max([r for r in cand if r["dtype"] == "bfloat16"]
                        or cand, key=lambda r: r["bound_ms"])
                paths[net] = dict(launches=n[name], **{k: r[k] for k in keys})
        top = max(paths.values(), key=lambda p: p["launches"])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(p["launches"] for p in paths.values()),
            **{k: top[k] for k in keys}, by_path=paths))
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
