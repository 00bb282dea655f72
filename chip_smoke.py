#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pcfa_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from
`pcfa_tpu_torch/csrc/` itself (nvcc, sm_90a) and needs one card. Phases,
each of which raises on failure (the script then exits non-zero):

1. build: toolchain, build time, the card's name and power limit;
2. kernels: every kernel of the RAFT PCFA path against its plain PyTorch
   version on the card, at the main path's shapes, in float32 and bf16,
   with kernel, plain-version and library-call times and the bound;
3. parity: a random-init RAFT (seed 0, flow-head conv2 damped ×0.01),
   128×128, 3 iterations, float32, on the CPU (plain versions) and on the
   card (kernels): flows and input gradients;
4. main path: the disjoint PCFA attack on full RAFT (12 iterations) at the
   KITTI shape (375×1242 padded to 376×1248), 2 random pairs at once, bf16
   network and bf16 compact L-BFGS history, δ-bound 0.005, zero target,
   AEE, clipping, history 100; steps 2 × max_iter 2 so the run stays short.
   Every kernel's launch count must go up during this run.

It prints a `{"kernels": [...]}` line, the card's name and power limit, and
last `{"ok": true, "device": {...}}`. Without CUDA it exits non-zero and
prints no result. `--profile` adds a `torch.profiler` table of one outer
step of the main path (device busy share, top kernels by device time).
"""

from __future__ import annotations

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

# (name, wrapper attribute, source, TPU kernel it replaces)
KERNELS = [
    ("corr_lookup_fwd", "corr_window_fwd", "pcfa_tpu_torch/csrc/corr_lookup.cu",
     "pcfa_tpu/ops/pallas/corr_lookup.py:123"),
    ("corr_lookup_bwd", "corr_window_bwd", "pcfa_tpu_torch/csrc/corr_lookup.cu",
     "pcfa_tpu/ops/pallas/corr_lookup.py:160"),
    ("small_conv_fwd", "small_conv_fwd", "pcfa_tpu_torch/csrc/small_conv.cu",
     "pcfa_tpu/ops/pallas/small_conv.py:170"),
    ("small_conv_dx", "small_conv_dx", "pcfa_tpu_torch/csrc/small_conv.cu",
     "pcfa_tpu/ops/pallas/small_conv.py:350"),
]


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


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


def check_close(what: str, got, ref, tol: float) -> float:
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs().nan_to_num(nan=float("inf"))
    err = float(diff.max())
    scale = max(1.0, float(ref.abs().max()))
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


def phase_kernels():
    from pcfa_tpu_torch.ops import corr_lookup as cl
    from pcfa_tpu_torch.ops import small_conv as sc

    gen = torch.Generator().manual_seed(0)
    rows = []
    card = card_line()

    def row(name, dtype, shape, err, ms, plain, lib, nbytes, flops):
        b, by = bound_ms(nbytes, flops, dtype)
        rows.append(dict(name=name, dtype=str(dtype).split(".")[-1],
                         shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b, bound_by=by,
                         nbytes=nbytes, flops=flops))
        log(f"  {name:16s} {rows[-1]['dtype']:8s} {shape:34s} err {err:.3g}"
            f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  library "
            f"{lib:.4f} ms  bound {b:.4f} ms ({by})  [{card}]")

    # tolerances relative to the values' scale: float32 convs differ from
    # cuDNN (TF32 off) by summation order; the plain lookup's grid_sample
    # moves sample positions by ~1e-5 px at x ≈ 150 (normalize/unnormalize
    # round trip); bf16 outputs differ by bf16 rounding
    log("# kernels vs plain (main-path shapes; tolerances: float32 1e-4, "
        "bf16 3e-2, relative to the values' scale)")
    for dtype, tol_l, tol_c in ((torch.float32, 1e-4, 1e-4),
                                (torch.bfloat16, 3e-2, 3e-2)):
        isz = torch.empty((), dtype=dtype).element_size()
        levels, coords = kitti_lookup_inputs(dtype, gen)
        n = coords.shape[0]
        shape = f"N={n} L=4 r=4 (47x156..5x19)"
        out = cl.corr_window_fwd(levels, coords, R)
        torch.cuda.synchronize()
        err = check_close("corr lookup fwd", out,
                          cl.corr_window_plain(levels, coords, R), tol_l)
        # grid_sample needs its grid in the map's dtype: a bf16 grid rounds
        # pixel positions, so in bf16 it is a timing yardstick only
        grids = [gr.to(dtype) for gr in grid_sample_lookup(levels, coords)]
        lib = cuda_ms(lambda: [F.grid_sample(
            lv[:, None], g, mode="bilinear", padding_mode="zeros",
            align_corners=True) for lv, g in zip(levels, grids)])
        cells = lookup_patch_cells(levels, coords)
        row("corr_lookup_fwd", dtype, shape, err,
            cuda_ms(lambda: cl.corr_window_fwd(levels, coords, R)),
            cuda_ms(lambda: cl.corr_window_plain(levels, coords, R)), lib,
            cells * isz + coords.numel() * 4 + out.numel() * isz,
            3 * 3 * out.numel())
        g = torch.randn(out.shape, generator=gen).to("cuda", dtype)
        got = cl.corr_window_bwd(g, levels, coords, R)
        ref = cl.corr_window_bwd_plain(g, levels, coords, R)
        torch.cuda.synchronize()
        err = max(check_close("corr lookup bwd", a, b, tol_l)
                  for a, b in zip(got, ref))
        del got, ref
        p = 2 * R + 1
        gs = [g[:, i * p * p:(i + 1) * p * p].reshape(n, 1, p, p)
              for i in range(len(levels))]
        lib = cuda_ms(lambda: [torch.ops.aten.grid_sampler_2d_backward(
            gl, lv[:, None], gr, 0, 0, True, [True, False])
            for gl, lv, gr in zip(gs, levels, grids)], reps=5)
        dmap_elems = sum(lv.numel() for lv in levels)
        row("corr_lookup_bwd", dtype, shape, err,
            cuda_ms(lambda: cl.corr_window_bwd(g, levels, coords, R), reps=5),
            cuda_ms(lambda: cl.corr_window_bwd_plain(g, levels, coords, R),
                    reps=5), lib,
            g.numel() * isz + coords.numel() * 4 + dmap_elems * isz,
            4 * 3 * cells)
        del levels, g, grids, gs, out

        for tag, (B, c_in, h, w, c_out, k, s) in (
                ("stem k7 s2 3->64", (4, 3, 376, 1248, 64, 7, 2)),
                ("layer1 k3 s1 64->64", (4, 64, 188, 624, 64, 3, 1))):
            x = torch.randn((B, c_in, h, w), generator=gen).to("cuda", dtype)
            wt = (torch.randn((c_out, c_in, k, k), generator=gen)
                  / math.sqrt(c_in * k * k)).to("cuda", dtype)
            bias = torch.randn(c_out, generator=gen).to("cuda", dtype)
            out = sc.small_conv_fwd(x, wt, bias, s)
            torch.cuda.synchronize()
            err = check_close(f"conv fwd {tag}", out, sc.conv_plain(
                x.float(), wt.float(), bias.float(), s), tol_c)
            flops = 2 * out.numel() * c_in * k * k
            io = (x.numel() + wt.numel() + bias.numel() + out.numel()) * isz
            shape = f"x={tuple(x.shape)} {tag}"
            row("small_conv_fwd", dtype, shape, err,
                cuda_ms(lambda: sc.small_conv_fwd(x, wt, bias, s)),
                cuda_ms(lambda: sc.conv_plain(x, wt, bias, s)),
                cuda_ms(lambda: F.conv2d(x, wt, bias, s, k // 2)), io, flops)
            gout = torch.randn(out.shape, generator=gen).to("cuda", dtype)
            dx = sc.small_conv_dx(gout, wt, x.shape, s)
            torch.cuda.synchronize()
            err = check_close(f"conv dx {tag}", dx, sc.conv_dx_plain(
                gout.float(), wt.float(), x.shape, s), tol_c)
            plain = cuda_ms(lambda: sc.conv_dx_plain(gout, wt, x.shape, s))
            lib = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                gout, x, wt, None, [s, s], [k // 2, k // 2], [1, 1], False,
                [0, 0], 1, [True, False, False]))
            row("small_conv_dx", dtype, shape, err,
                cuda_ms(lambda: sc.small_conv_dx(gout, wt, x.shape, s)),
                plain, lib,
                (gout.numel() + wt.numel() + dx.numel()) * isz, flops)
            del x, out, gout, dx
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ 3 ---

def phase_parity():
    """Card (kernels) vs CPU (plain versions), float32. Flows: rtol/atol
    1e-3. Input gradients: float32 rounding switches a few ReLU units of a
    random-init RAFT on or off (pre-activations within ~1e-6 of the kink),
    which moves single gradient elements by up to ~5e-3 of a ~0.2 scale on
    both devices alike; so the gradients are held to a relative L2 error of
    1e-2 and 99.5% of their elements to rtol/atol 1e-3."""
    import copy

    from pcfa_tpu_torch.runtime import load_model

    loaded = load_model("RAFT", init_random=True, seed=0, device="cpu",
                        iters=3)
    with torch.no_grad():
        loaded.module.update_block.flow_head.conv2.weight.mul_(0.01)
        loaded.module.update_block.flow_head.conv2.bias.mul_(0.01)
    models = {"cpu": loaded.module,
              "cuda": copy.deepcopy(loaded.module).to("cuda")}
    rng = np.random.default_rng(0)
    i1, i2 = (torch.from_numpy(rng.random((2, 128, 128, 3)).astype(np.float32))
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((2, 128, 128, 2))
                         .astype(np.float32))
    res = {}
    for dev, model in models.items():
        a = i1.clone().to(dev).requires_grad_(True)
        b = i2.clone().to(dev).requires_grad_(True)
        _, up = model(a, b)
        (up * g.to(dev)).sum().backward()
        res[dev] = [t.detach().cpu().double() for t in (up, a.grad, b.grad)]
    up_c, *grads_c = res["cpu"]
    up_g, *grads_g = res["cuda"]
    err_up = float((up_g - up_c).abs().max())
    if not torch.allclose(up_g, up_c, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"parity: flow_up max abs err {err_up}")
    worst = []
    for name, gg, gc in zip(("d image1", "d image2"), grads_g, grads_c):
        rel_l2 = float((gg - gc).norm() / gc.norm())
        within = float(((gg - gc).abs() <= 1e-3 + 1e-3 * gc.abs())
                       .double().mean())
        worst.append((name, rel_l2, within, float((gg - gc).abs().max())))
        if not (rel_l2 <= 1e-2 and within >= 0.995):
            raise AssertionError(f"parity: {name} rel L2 {rel_l2}, "
                                 f"{within:.4%} within tolerance")
    log(f"# parity card vs CPU (RAFT 128x128, 3 iters, fp32): flow_up max "
        f"abs err {err_up:.3g}; " + "; ".join(
            f"{n}: rel L2 {r:.3g}, {w:.4%} within 1e-3, max abs {m:.3g}"
            for n, r, w, m in worst))


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


def phase_main_path(profile: bool = False):
    os.environ.setdefault("PCFA_COMPUTE_DTYPE", "bfloat16")
    os.environ.setdefault("PCFA_LBFGS_DTYPE", "bfloat16")
    os.environ.setdefault("PCFA_LBFGS_DIRECTION", "compact")
    from pcfa_tpu_torch import config
    from pcfa_tpu_torch.attack import pcfa
    from pcfa_tpu_torch.ops import corr_lookup as cl
    from pcfa_tpu_torch.ops import small_conv as sc
    from pcfa_tpu_torch.runtime import load_model, make_flow_fn

    cfg = pcfa.PCFAConfig(
        steps=2, max_iter=2, delta_bound=0.005, loss="aee", target="zero",
        boxconstraint="clipping", history_size=100,
        lbfgs_direction=config.lbfgs_direction(),
        lbfgs_history_dtype=config.lbfgs_history_dtype("RAFT"))
    log(f"# main path: RAFT iters 12, {KITTI_HW[0]}x{KITTI_HW[1]} padded to "
        f"÷8, pairs {PAIRS}, compute {os.environ['PCFA_COMPUTE_DTYPE']}, "
        f"config {cfg}")
    loaded = load_model("RAFT", init_random=True, seed=0)
    padder, flow_fn = make_flow_fn(loaded, KITTI_HW, pad_mode="kitti")
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.random((PAIRS, *KITTI_HW, 3))
                             .astype(np.float32)).cuda() for _ in range(2)]
    image1, image2 = padder.pad(*imgs)
    target = torch.zeros((PAIRS, *KITTI_HW, 2), device="cuda")

    wrappers = [cl.corr_window_fwd, cl.corr_window_bwd, sc.small_conv_fwd,
                sc.small_conv_dx]
    for w in wrappers:
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
    launches = {w.__name__: w.launches for w in wrappers}
    peak = torch.cuda.max_memory_allocated()

    for name, v in metrics._asdict().items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"main path: metric {name} not finite: {v}")
    if not (torch.isfinite(flow_pred).all() and torch.isfinite(state.opt.x)
            .all()):
        raise AssertionError("main path: non-finite flow or iterate")
    if flow_pred.shape != (PAIRS, *KITTI_HW, 2):
        raise AssertionError(f"main path: flow shape {tuple(flow_pred.shape)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

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
    published = (20 * 10 * it_s + 21 * fwd) / PAIRS
    card = card_line()
    log("# main path metrics (last step, per pair): " + ", ".join(
        f"{k} {v.tolist()}" for k, v in metrics._asdict().items()))
    log(f"# main path: run {t_run:.3f} s ({cfg.steps} steps × "
        f"{cfg.max_iter} iters, {PAIRS} pairs) = {PAIRS / t_run:.4f} pairs/s;"
        f" outer steps {[round(t, 3) for t in t_steps]} s; closure "
        f"(fwd+bwd, {PAIRS} pairs) {1e3 * closure:.1f} ms; forward "
        f"{1e3 * fwd:.1f} ms; L-BFGS iteration {1e3 * it_s:.1f} ms; "
        f"projected published config (20×10 + 21 fwd): {1 / published:.5f} "
        f"pairs/s; peak memory {peak / 2**30:.2f} GiB [{card}]")
    log(f"# main path launches: {json.dumps(launches)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import pcfa_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pcfa_tpu_torch._device import resolve_device

    resolve_device("cuda")  # float32 means float32 on the card (no TF32)
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    launches = phase_main_path(profile="--profile" in sys.argv[1:])

    kernels = []
    for name, attr, src, replaces in KERNELS:
        # the main path's dtype (bf16) and, for the convs, the layer1 shape
        # (8 of the 10 launches per closure); every row is printed above
        r = next(r for r in reversed(rows) if r["name"] == name)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[attr], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            dtype=r["dtype"], shape=r["shape"]))
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
