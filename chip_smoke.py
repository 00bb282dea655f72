#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pcfa_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from
`pcfa_tpu_torch/csrc/` itself (nvcc, sm_90a, one process per source, all
at once) and needs one card. Phases, each of which raises on failure (the
script then exits non-zero):

1. build: toolchain, build time, the card's name and power limit;
2. kernels: every kernel of the RAFT and PWCNet PCFA paths against its
   plain PyTorch version on the card, at each main path's shapes (the
   small conv at RAFT's and at all of PWCNet's, with PWCNet's leaky
   epilogue and its derivative fused into dx), in float32 and bf16 (the
   small conv's bf16 is its tensor-core kernel, float32 its CUDA-core
   route; segsum: float32, the only dtype its path sends), with kernel,
   plain-version and library-call times and the bound (plus the patch
   correlation at FlowNetC's shape). The lookup's backward adds into
   buffers the caller owns: it is held against the plain accumulating
   backward over 4 launches, and a `corr_lookup_closure` row checks and
   times what one RAFT closure does with the lookup (the pyramid, 12
   lookups, their backward through autograd). Each row says how its kernel and
   library times were taken: `loop` (10 launches back to back) or `graph`
   (a CUDA-graph replay: device time, warm L2, the loop time beside it),
   which every kernel row of the lookup, PWCNet's convs, the patch
   correlation and segsum uses;
3. parity: a random-init RAFT (seed 0, flow-head conv2 damped ×0.01),
   128×128, 3 iterations, and a random-init PWCNet (seed 0), 128×128, 2
   pairs, both float32, on the CPU (plain versions) and on the card
   (kernels): flows and input gradients;
4. main path, RAFT: the disjoint PCFA attack on full RAFT (12 iterations)
   at the KITTI shape (375×1242 padded to 376×1248), 2 random pairs at
   once, bf16 network and bf16 compact L-BFGS history, δ-bound 0.005, zero
   target, AEE, clipping, history 100; steps 2 × max_iter 2 so the run
   stays short;
5. main path, PWCNet: the same attack on full PWCNet at 375×1242 padded
   to ÷64 (384×1280), 1 pair, bf16 network and a float32 L-BFGS history
   (PWCNet refuses a bf16 one), in an environment of its own.
Every kernel of a path must be launched during that path's run (the
counts are set to 0 just before it and read just after). Before each main
path it times 2,000 tiny launches: the host's launch cost, which sets the
pace of a host-bound step.

It prints a `{"kernels": [...]}` line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`. Without CUDA it exits non-zero and
prints no result. `--profile` adds a `torch.profiler` table of one outer
step of each main path (device busy share, top kernels by device time).
"""

from __future__ import annotations

import contextlib
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
    ("segsum", "segsum", "segment_rows_cuda",
     "pcfa_tpu_torch/csrc/segsum.cu",
     "pcfa_tpu/ops/pallas/segsum.py:170"),
]
# the kernels each main path must launch
PATH_KERNELS = {
    "RAFT": ["corr_lookup_fwd", "corr_lookup_bwd", "small_conv_fwd",
             "small_conv_dx"],
    "PWCNet": ["local_corr_fwd", "local_corr_bwd", "segsum",
               "small_conv_fwd", "small_conv_dx"],
}


def wrapper(name: str):
    """The launching wrapper of kernel `name` (it carries `.launches`)."""
    import importlib

    _, mod, attr, _, _ = next(k for k in KERNELS if k[0] == name)
    return getattr(importlib.import_module(f"pcfa_tpu_torch.ops.{mod}"),
                   attr)


@contextlib.contextmanager
def restored_env():
    """Whatever a phase sets in os.environ is undone when it ends."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


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


def lookup_patch_cells(levels, coords) -> int:
    """In-map cells of every query's (2r+2)² patch, all levels: what the
    lookup must read for this run's coords."""
    total = 0
    for i, lv in enumerate(levels):
        h, w = lv.shape[1:]
        c = coords / 2 ** i
        x0 = torch.floor(c[:, 0]) - R
        y0 = torch.floor(c[:, 1]) - R
        side = 2 * R + 2
        nx = (torch.clamp(x0 + side, 0, w) - torch.clamp(x0, 0, w)).clamp(min=0)
        ny = (torch.clamp(y0 + side, 0, h) - torch.clamp(y0, 0, h)).clamp(min=0)
        total += int((nx * ny).sum())
    return total


def grid_sample_lookup(levels, coords):
    """The library call: one `F.grid_sample` per level (the reference
    RAFT's CorrBlock form), used here as a yardstick only."""
    p = 2 * R + 1
    lin = torch.linspace(-R, R, p, device=coords.device)
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
    kernels_local_corr(rows)
    kernels_segsum(rows)
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
        lookup_closure(gen, dtype, tol_l)
        for tag, (B, c_in, h, w, c_out, k, s) in (
                ("stem k7 s2 3->64", (4, 3, 376, 1248, 64, 7, 2)),
                ("layer1 k3 s1 64->64", (4, 64, 188, 624, 64, 3, 1))):
            conv_rows(row, gen, dtype, tol_c, tag, "RAFT",
                      (B, c_in, h, w, c_out, k, s), None)


def lookup_rows(row, gen, dtype, tol):
    """The lookup's forward and its accumulating backward at RAFT's shape.
    The backward adds into buffers the caller owns: 4 launches with
    different coords into one zeroed set are held against the plain
    accumulating backward (each launch's gradient rounded to the maps'
    dtype and added), then one launch is timed. Its bound counts the
    cotangent read and the in-map patch cells read and written."""
    from pcfa_tpu_torch.ops import corr_lookup as cl

    isz = torch.empty((), dtype=dtype).element_size()
    levels, coords = kitti_lookup_inputs(dtype, gen)
    n = coords.shape[0]
    shape = f"N={n} L=4 r=4 (47x156..5x19)"
    out = cl.corr_window_fwd(levels, coords, R)
    torch.cuda.synchronize()
    err = check_close("corr lookup fwd", out,
                      cl.corr_window_plain(levels, coords, R), tol)
    # grid_sample needs its grid in the map's dtype: a bf16 grid rounds
    # pixel positions, so in bf16 it is a timing yardstick only
    grids = [gr.to(dtype) for gr in grid_sample_lookup(levels, coords)]
    lib = graph_ms(lambda: [F.grid_sample(
        lv[:, None], g, mode="bilinear", padding_mode="zeros",
        align_corners=True) for lv, g in zip(levels, grids)])
    cells = lookup_patch_cells(levels, coords)
    fwd = lambda: cl.corr_window_fwd(levels, coords, R)  # noqa: E731
    row("corr_lookup_fwd", dtype, shape, err, graph_ms(fwd),
        cuda_ms(lambda: cl.corr_window_plain(levels, coords, R)), lib,
        cells * isz + coords.numel() * 4 + out.numel() * isz,
        3 * 3 * out.numel(), "RAFT", "graph", cuda_ms(fwd))

    g = torch.randn(out.shape, generator=gen).to("cuda", dtype)
    got = [torch.zeros_like(t) for t in levels]
    ref = [torch.zeros_like(t) for t in levels]
    for i in range(4):
        c = coords + 2.0 * i
        cl.corr_window_bwd(g, got, c, R)
        cl.corr_window_bwd_acc_plain(g, ref, c, R)
    torch.cuda.synchronize()
    err = max(check_close("corr lookup bwd (4 launches)", a, b, tol)
              for a, b in zip(got, ref))
    p = 2 * R + 1
    gs = [g[:, i * p * p:(i + 1) * p * p].reshape(n, 1, p, p)
          for i in range(len(levels))]
    lib = graph_ms(lambda: [torch.ops.aten.grid_sampler_2d_backward(
        gl, lv[:, None], gr, 0, 0, True, [True, False])
        for gl, lv, gr in zip(gs, levels, grids)], reps=5)
    bwd = lambda: cl.corr_window_bwd(g, got, coords, R)  # noqa: E731
    row("corr_lookup_bwd", dtype, shape, err, graph_ms(bwd),
        cuda_ms(lambda: cl.corr_window_bwd_acc_plain(g, ref, coords, R),
                reps=5), lib,
        g.numel() * isz + coords.numel() * 4 + 2 * cells * isz,
        4 * 3 * cells, "RAFT", "graph", cuda_ms(bwd))


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
            path = "FlowNetC" if tag == "FlowNetC" else "PWCNet"
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


def kernels_segsum(rows):
    """The warp's segment row-sum at PWCNet's four warps at 384×1280
    (B = 1): N = H·W sample rows of K = 4C, nrows = (H+1)(W+1) window
    bases, indices from the packed sampler at a random flow of a few
    pixels; plus a collision-heavy case (level 2's rows into 64 cells).
    The rows are float32, the only dtype the kernel takes (the warp's
    backward builds them in float32). Tolerance 1e-4 of the largest plain
    value (atomics add in a varying order)."""
    from pcfa_tpu_torch.ops import segsum as sg
    from pcfa_tpu_torch.ops.warp import _corner_weights

    gen = torch.Generator().manual_seed(2)
    row = row_adder(rows)
    log("# segsum vs plain (PWCNet warps at 384x1280, B = 1)")
    dtype, tol, isz = torch.float32, 1e-4, 4
    cases = [("L2 collide", 96, 320, 32, True)] + [
        (n, h, w, c, False) for n, h, w, c in PWC_LEVELS[1:]]
    for tag, h, w, c, collide in cases:
        n, k, nrows = PWC_PAIRS * h * w, 4 * c, PWC_PAIRS * (h + 1) * (
            w + 1)
        if collide:
            idx = torch.randint(0, 64, (n,), generator=gen)
        else:
            ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w),
                                    indexing="ij")
            flow = 2.0 * torch.randn((PWC_PAIRS, h, w, 2), generator=gen)
            idx = _corner_weights((PWC_PAIRS, h, w, c), xs + flow[..., 0],
                                  ys + flow[..., 1], True)[0]
        idx = idx.to("cuda")
        upd = torch.randn((n, k), generator=gen).to("cuda", dtype)
        out = sg.segment_rows_cuda(idx, upd, nrows)
        torch.cuda.synchronize()
        err = check_close(f"segsum {tag}", out,
                          sg.segment_rows_plain(idx, upd, nrows), tol)
        kernel = lambda: sg.segment_rows_cuda(idx, upd, nrows)  # noqa: E731
        row("segsum", dtype, f"{tag} N={n} K={k} nrows={nrows}", err,
            graph_ms(kernel),
            cuda_ms(lambda: sg.segment_rows_plain(idx, upd, nrows)),
            graph_ms(lambda: torch.zeros((nrows, k), dtype=dtype,
                                         device="cuda").index_add_(
                                             0, idx, upd)),
            n * k * isz + n * 8 + nrows * k * isz, n * k,
            None if collide else "PWCNet", "graph", cuda_ms(kernel))
        del idx, upd, out


# ------------------------------------------------------------------ 3 ---

def card_vs_cpu(name, models, inputs, g):
    """Run `models` {'cpu', 'cuda'} on the same float32 inputs, backprop
    Σ flow·g and compare. Flows: rtol/atol 1e-3. Input gradients: float32
    rounding switches a few ReLU/LeakyReLU units of a random-init net on or
    off (pre-activations within ~1e-6 of the kink), which moves single
    gradient elements by up to ~5e-3 of a ~0.2 scale on both devices
    alike; so the gradients are held to a relative L2 error of 1e-2 and
    99.5% of their elements to rtol/atol 1e-3."""
    res = {}
    for dev, model in models.items():
        a = inputs[0].clone().to(dev).requires_grad_(True)
        b = inputs[1].clone().to(dev).requires_grad_(True)
        up = model(a, b)
        up = up[-1] if isinstance(up, tuple) else up
        (up * g.to(dev)).sum().backward()
        res[dev] = [t.detach().cpu().double() for t in (up, a.grad, b.grad)]
    up_c, *grads_c = res["cpu"]
    up_g, *grads_g = res["cuda"]
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
    log(f"# parity card vs CPU ({name}): flow max abs err {err_up:.3g} "
        f"(scale {float(up_c.abs().max()):.3g}); " + "; ".join(
            f"{n}: rel L2 {r:.3g}, {w:.4%} within 1e-3, max abs {m:.3g}"
            for n, r, w, m in worst))


def phase_parity():
    """Card (kernels) vs CPU (plain versions), float32: RAFT (flow-head
    conv2 damped ×0.01, 3 iterations) and PWCNet, each 128×128, 2 pairs."""
    import copy

    from pcfa_tpu_torch.runtime import load_model

    rng = np.random.default_rng(0)
    i1, i2 = (torch.from_numpy(rng.random((2, 128, 128, 3)).astype(np.float32))
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((2, 128, 128, 2))
                         .astype(np.float32))
    loaded = load_model("RAFT", init_random=True, seed=0, device="cpu",
                        iters=3)
    with torch.no_grad():
        loaded.module.update_block.flow_head.conv2.weight.mul_(0.01)
        loaded.module.update_block.flow_head.conv2.bias.mul_(0.01)
    card_vs_cpu("RAFT 128x128, 3 iters, fp32",
                {"cpu": loaded.module,
                 "cuda": copy.deepcopy(loaded.module).to("cuda")},
                (i1, i2), g)
    loaded = load_model("PWCNet", init_random=True, seed=0, device="cpu")
    card_vs_cpu("PWCNet 128x128, fp32",
                {"cpu": loaded.module,
                 "cuda": copy.deepcopy(loaded.module).to("cuda")},
                (i1, i2), g)


# ------------------------------------------------------------------ 4 ---

def profile_step(step) -> None:
    """One call of `step` under `torch.profiler`: device busy share and the
    kernels that take the most device time."""
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
    log(f"# profile of one outer step: wall {wall_us / 1e3:.1f} ms (profiler "
        f"on), device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / wall_us:.1f}%); top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:30]:
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
    every kernel during the run."""
    from pcfa_tpu_torch import config
    from pcfa_tpu_torch.attack import pcfa
    from pcfa_tpu_torch.runtime import load_model, make_flow_fn

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
    wrappers = {name: wrapper(name) for name, *_ in KERNELS}
    for w in wrappers.values():
        w.launches = 0
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
    if profile:
        profile_step(lambda: pcfa.pcfa_outer_step(
            flow_fn, image1, image2, target, flow_init, state, cfg))
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
    log(f"# main path {net} launches: {json.dumps(launches)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import pcfa_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pcfa_tpu_torch._device import resolve_device

    resolve_device("cuda")  # float32 means float32 on the card (no TF32)
    profile = "--profile" in sys.argv[1:]
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    with restored_env():
        os.environ.setdefault("PCFA_COMPUTE_DTYPE", "bfloat16")
        os.environ.setdefault("PCFA_LBFGS_DTYPE", "bfloat16")
        os.environ.setdefault("PCFA_LBFGS_DIRECTION", "compact")
        by_path = {"RAFT": phase_main_path("RAFT", PAIRS, profile)}
    torch.cuda.empty_cache()
    with restored_env():
        # PWCNet refuses a bf16 history: unset, so float32
        os.environ["PCFA_COMPUTE_DTYPE"] = "bfloat16"
        os.environ["PCFA_LBFGS_DIRECTION"] = "compact"
        os.environ.pop("PCFA_LBFGS_DTYPE", None)
        by_path["PWCNet"] = phase_main_path("PWCNet", PWC_PAIRS, profile)

    kernels = []
    keys = ("shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "timed")
    for name, _, _, src, replaces in KERNELS:
        # per path, the row at its main-path dtype (bf16; segsum float32)
        # with the largest bound; the top-level numbers are those of the
        # path that launched the kernel most. Every row is printed above.
        paths = {}
        for net, n in by_path.items():
            if name in PATH_KERNELS[net]:
                cand = [r for r in rows if r["name"] == name
                        and r["path"] == net]
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
    sys.exit(main())
