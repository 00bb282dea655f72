"""`pcfa_tpu_torch.parallel` over two gloo processes on the CPU, against
`pcfa_tpu` and the port's one-process runs, and the one-process pieces
of the same slice: the border clamp's derivative, `RuntimeConfig` and
`available_models`.

The file is also its own worker: `python tests/test_torch_parallel.py
<case> <rank> <world> <port> <folder>` joins a gloo group of `world`
processes, runs the case with one torch thread, and saves what it got to
`<folder>/<case>_<rank>.npz`. A worker imports torch, numpy and the port,
never JAX. The parent writes the inputs (numpy seeds; weights filled
from a seed in the JAX trees' shapes and converted by the port's
`models/convert.py`), starts the two ranks, computes the references
while they run, and compares. One spawn per case, three in all:

* 'engines': `pcfa_attack_dp` (4 pairs over 2 ranks, against JAX's over a
  4-device 'data' mesh and the port's one-process run of each pair) and
  `universal_batch_attack_dp` ('aee', 'mse', 'cosim', disjoint and joint;
  2 pairs per rank, against the serial JAX `universal_batch_attack` on
  the 4), on the small float64 map of tests/test_torch_fgsm_universal.py;
* 'models': RAFT (materialized, and fused with blocks of 50) and GMA
  (`gamma` 0.5) split by rows over 2 ranks, 64×64, 2 pyramid levels, 2
  iterations, float64: flows and input gradients against the serial JAX
  models; the PCFA engine on the split RAFT against the port's unsplit
  run; the two refusals (H/8 not divisible, 'hybrid');
* 'cli': `attack_pcfa` per pair (3 Synthetic pairs, so one rank has one
  more) and universal (one pair per rank) on SpyNet at 64×64: rank 0's
  `metrics.jsonl` against the one-process runs'.

Float64 comparisons hold at 1e-9 unless a test says otherwise and why.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 8, 12             # the small map's frames
MH = MW = 64             # the models' frames
PCFA_KW = dict(steps=2, max_iter=3, history_size=5, delta_bound=0.01)
UNI_KW = dict(steps=2, max_iter=3, history_size=5, delta_bound=0.01,
              mu=50.0)
UNI_CASES = [(loss, joint) for loss in ("aee", "mse", "cosim")
             for joint in (False, True)]
MODEL_CASES = {"raft": ("RAFT", {}),
               "raft_fused": ("RAFT", dict(corr_impl="fused",
                                           corr_block=50)),
               "gma": ("GMA", {})}
SPY_ENV = {"PCFA_SYNTHETIC_SIZE": f"{MH}x{MW}", "PCFA_NO_MLFLOW": "1"}
CLI_ARGS = ["--net=SpyNet", "--dataset=Synthetic",
            "--dataset_stage=training", "--unregistered_artifacts",
            "--boxconstraint=clipping", "--steps=1"]


# ------------------------------------------------------------ shared ---

def small_map(k, bias):
    """The float64 flow map of tests/test_torch_fgsm_universal.py: a 3×3
    conv of the stacked pair (6 → 2 channels) plus a bias, through tanh."""
    import torch.nn.functional as F

    kt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))

    def flow(a, b):
        x = torch.cat([a, b], -1).permute(0, 3, 1, 2)
        y = F.conv2d(x, kt, padding=1).permute(0, 2, 3, 1)
        return torch.tanh(y + torch.from_numpy(bias))

    return flow


def _leaves(tree):
    out = []
    for v in tree:
        out.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return out


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ worker ---

def _engines(rank, folder):
    from pcfa_tpu_torch.attack import lbfgs, universal
    from pcfa_tpu_torch.attack.pcfa import PCFAConfig
    from pcfa_tpu_torch.parallel import (data_mesh, pcfa_attack_dp,
                                         universal_batch_attack_dp)

    d = np.load(os.path.join(folder, "engines_in.npz"))
    flow = small_map(d["k"], d["bias"])
    mesh = data_mesh(2)
    i1, i2, tgt = (torch.from_numpy(d[n]) for n in ("i1", "i2", "tgt"))
    out = {}
    res = pcfa_attack_dp(flow, i1, i2, tgt, PCFAConfig(**PCFA_KW), mesh,
                         device="cpu")
    for i, leaf in enumerate(_leaves(res)):
        out[f"dp_{i}"] = _np(leaf)
    rows = slice(2 * rank, 2 * rank + 2)
    n = H * W * 3
    for loss, joint in UNI_CASES:
        cfg = universal.UniversalConfig(loss=loss, joint_perturbation=joint,
                                        **UNI_KW)
        state = lbfgs.lbfgs_init(torch.zeros(
            (1, n * (1 if joint else 2)), dtype=torch.float64), 5)
        state, m, init, pred = universal_batch_attack_dp(
            flow, i1[rows], i2[rows], tgt[rows], state, cfg, mesh)
        tag = f"uni_{loss}_{int(joint)}"
        out[f"{tag}_x"] = _np(state.x[0])
        out[f"{tag}_count"] = np.asarray(int(state.count[0]))
        out[f"{tag}_pred"] = _np(pred)
        for name, v in m._asdict().items():
            out[f"{tag}_{name}"] = _np(v)
    return out


def _models(rank, folder):
    from pcfa_tpu_torch.attack.pcfa import PCFAConfig, pcfa_attack
    from pcfa_tpu_torch.models import make_model
    from pcfa_tpu_torch.parallel import space_mesh, spatial_flow_fn

    d = np.load(os.path.join(folder, "models_in.npz"))
    mesh = space_mesh(2)
    i1, i2, g = (torch.from_numpy(d[n]) for n in ("i1", "i2", "g"))
    out = {}

    def sharded(case, **kw):
        name, extra = MODEL_CASES[case]
        model, _ = make_model(name, iters=2, corr_levels=2,
                              spatial_shards=2, **extra, **kw)
        model.load_state_dict(torch.load(os.path.join(
            folder, f"{case}.pt")))
        return model.double().eval().requires_grad_(False)

    for case in MODEL_CASES:
        flow_fn = spatial_flow_fn(sharded(case), mesh)
        a, b = (t.clone().requires_grad_(True) for t in (i1, i2))
        up = flow_fn(a, b)
        (up * g).sum().backward()
        out.update({f"{case}_up": _np(up), f"{case}_d1": _np(a.grad),
                    f"{case}_d2": _np(b.grad)})

    flow_fn = spatial_flow_fn(sharded("raft"), mesh)
    res = pcfa_attack(flow_fn, i1, i2, torch.zeros_like(g),
                      PCFAConfig(steps=1, max_iter=2), device="cpu")
    for i, leaf in enumerate(_leaves(res)):
        out[f"pcfa_{i}"] = _np(leaf)

    x = torch.zeros((1, 72, MW, 3), dtype=torch.float64)
    for what, fn in (("rows", lambda: flow_fn(x, x)),
                     ("hybrid", lambda: spatial_flow_fn(
                         sharded("raft", corr_impl="hybrid"), mesh)(i1, i2))):
        try:
            fn()
            out[f"err_{what}"] = np.asarray("")
        except (ValueError, NotImplementedError) as e:
            out[f"err_{what}"] = np.asarray(f"{type(e).__name__}: {e}")
    return out


def _cli(rank, folder):
    from pcfa_tpu_torch.cli import attack_pcfa

    os.environ.update(SPY_ENV)
    os.environ["PCFA_SYNTHETIC_COUNT"] = "3"
    attack_pcfa.main([*CLI_ARGS, "--pairs_per_device=1",
                      f"--output_folder={os.path.join(folder, 'dp_pairs')}"],
                     device="cpu")
    os.environ["PCFA_SYNTHETIC_COUNT"] = "2"
    attack_pcfa.main([*CLI_ARGS, "--universal_perturbation",
                      "--batch_size=1", "--epochs=1", "--steps=1",
                      f"--output_folder={os.path.join(folder, 'dp_uni')}"],
                     device="cpu")
    return {"done": np.asarray(1)}


def worker(case, rank, world, port, folder):
    import torch.distributed as dist

    from pcfa_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo",
                         timeout_s=120)
    out = {"engines": _engines, "models": _models, "cli": _cli}[case](
        rank, folder)
    np.savez(os.path.join(folder, f"{case}_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    case, rank, world, port, folder = sys.argv[1:]
    worker(case, int(rank), int(world), int(port), folder)
    sys.exit(0)


# ------------------------------------------------------------ parent ---

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while this module runs: the suite runs a
    pytest worker per core, and torch's default of a thread per core makes
    the workers contend (a planner case of test_torch_kernels.py took 96 s
    beside five other workers, 8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Ranks:
    """Two worker processes of `case`, started at once, their output in
    `<folder>/<case>_<rank>.log`; `wait()` raises with a rank's output when
    it failed or outlived `timeout` seconds."""

    def __init__(self, case, folder, timeout=240):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_", "MASTER_", "WORLD_",
                                    "RANK", "LOCAL_"))}
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        port = _free_port()
        self.case, self.folder, self.timeout = case, str(folder), timeout
        self.logs = [os.path.join(self.folder, f"{case}_{r}.log")
                     for r in range(2)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), case,
                     str(r), "2", str(port), self.folder], cwd=self.folder,
                    env=env, stdout=f, stderr=subprocess.STDOUT))

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self):
        try:
            for p in self.procs:
                p.wait(timeout=self.timeout)
        finally:
            self.kill()
        for r, (p, log) in enumerate(zip(self.procs, self.logs)):
            with open(log) as f:
                out = f.read()
            assert p.returncode == 0, \
                f"{self.case} rank {r} exited {p.returncode}:\n{out[-4000:]}"
        return [dict(np.load(os.path.join(self.folder,
                                          f"{self.case}_{r}.npz")))
                for r in range(2)]


def _frames(rng, shape):
    x = np.round(rng.random(shape) * 255.0) / 255.0
    x[..., :2, :3, :] = 0.0
    x[..., 2:4, 3:5, :] = 1.0
    return x


def _jax_map(k, bias):
    def jflow(a, b):
        y = jax.lax.conv_general_dilated(
            jnp.concatenate([a, b], -1), k, (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.tanh(y + bias)

    return jflow


def _close(got, want, name, tol=1e-9):
    """1e-9; `two_norm_avg` sums in float32 in both packages (1e-6)."""
    got, want = np.asarray(got), np.asarray(want)
    tol = max(tol, 1e-6) if got.dtype == np.float32 else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The three cases' inputs, and their ranks started at once (six
    processes), so that they run while this process computes the
    references."""
    from pcfa_tpu_torch.models.convert import (gma_params_from_jax,
                                               raft_params_from_jax)

    folders = {c: tmp_path_factory.mktemp(c)
               for c in ("engines", "models", "cli")}
    rng = np.random.default_rng(0)
    k = 0.5 * rng.standard_normal((3, 3, 6, 2))
    bias = np.array([0.3, -0.2])
    i1, i2 = _frames(rng, (4, H, W, 3)), _frames(rng, (4, H, W, 3))
    tgt = 0.1 * rng.standard_normal((4, H, W, 2))
    engines = dict(k=k, bias=bias, i1=i1, i2=i2, tgt=tgt)
    np.savez(folders["engines"] / "engines_in.npz", **engines)

    rng = np.random.default_rng(3)
    i1, i2 = (rng.random((1, MH, MW, 3)) for _ in range(2))
    g = rng.standard_normal((1, MH, MW, 2))
    models = dict(i1=i1, i2=i2, g=g)
    np.savez(folders["models"] / "models_in.npz", **models)
    trees = {"RAFT": _model_tree("RAFT"), "GMA": _model_tree("GMA")}
    bridge = {"RAFT": raft_params_from_jax, "GMA": gma_params_from_jax}
    for case, (name, _) in MODEL_CASES.items():
        torch.save(bridge[name](trees[name]), folders["models"] / f"{case}.pt")
    models["trees"] = trees
    ranks = {c: _Ranks(c, f) for c, f in folders.items()}
    yield dict(ranks=ranks, folders=folders, engines=engines, models=models)
    for r in ranks.values():
        r.kill()


@pytest.fixture(scope="module")
def engines(spawned):
    """The 'engines' ranks' results and their references."""
    from pcfa_tpu.attack import lbfgs as jlbfgs
    from pcfa_tpu.attack import pcfa as jpcfa
    from pcfa_tpu.attack import universal as juniversal
    from pcfa_tpu.parallel import data_mesh as jdata_mesh
    from pcfa_tpu.parallel import pcfa_attack_dp as jpcfa_attack_dp

    d = spawned["engines"]
    k, bias, i1, i2, tgt = (d[n] for n in ("k", "bias", "i1", "i2", "tgt"))
    jflow = _jax_map(k, bias)
    ref = {}
    with jax.enable_x64(True):
        jres = jpcfa_attack_dp(jflow, *(jnp.asarray(a) for a in (i1, i2,
                                                                 tgt)),
                               jpcfa.PCFAConfig(**PCFA_KW), jdata_mesh(4))
        ref["dp"] = [np.asarray(v) for v in _leaves(jres)]
        n = H * W * 3
        for loss, joint in UNI_CASES:
            cfg = juniversal.UniversalConfig(
                loss=loss, joint_perturbation=joint, **UNI_KW)
            state = jlbfgs.lbfgs_init(
                jnp.zeros((n * (1 if joint else 2),), jnp.float64), 5)
            ref[(loss, joint)] = jax.tree.map(
                np.asarray, jax.jit(
                    lambda a, b, t, s, cfg=cfg:
                    juniversal.universal_batch_attack(jflow, a, b, t, s,
                                                      cfg))(
                        *(jnp.asarray(a) for a in (i1, i2, tgt)), state))
    return dict(out=spawned["ranks"]["engines"].wait(), ref=ref, **d)


def test_pcfa_attack_dp_matches_jax_and_one_process(engines):
    """4 pairs over 2 ranks: every rank returns the gathered result of
    all 4, equal to JAX's `pcfa_attack_dp` over a 4-device 'data' mesh,
    and each pair equal to the port's one-process attack of that pair."""
    from pcfa_tpu_torch.attack.pcfa import (PCFAConfig, PCFAMetrics,
                                            PCFAResult, pcfa_attack)

    out, ref = engines["out"], engines["ref"]
    names = [*PCFAResult._fields[:-1], *PCFAMetrics._fields]
    assert len(ref["dp"]) == len(names)
    got = [out[0][f"dp_{i}"] for i in range(len(names))]
    for i, name in enumerate(names):
        assert got[i].shape[0] == 4, name
        np.testing.assert_array_equal(out[1][f"dp_{i}"], got[i],
                                      err_msg=f"rank 1's {name}")
        _close(got[i], ref["dp"][i], f"JAX {name}")
    flow = small_map(engines["k"], engines["bias"])
    for p in range(4):
        one = pcfa_attack(flow, *(torch.from_numpy(engines[n][p:p + 1])
                                  for n in ("i1", "i2", "tgt")),
                          PCFAConfig(**PCFA_KW), device="cpu")
        for i, leaf in enumerate(_leaves(one)):
            _close(got[i][p:p + 1], _np(leaf), f"pair {p} leaf {i}")


@pytest.mark.parametrize("loss,joint", UNI_CASES)
def test_universal_dp_matches_serial_jax(engines, loss, joint):
    """One δ on a batch of 4 split 2 + 2 over the ranks: the state, the
    last flows and the per-step metrics against the serial JAX engine on
    the 4 pairs; both ranks' δ bit-identical."""
    from pcfa_tpu_torch.attack.universal import UniversalMetrics

    out = engines["out"]
    jstate, jm, _, jpred = engines["ref"][(loss, joint)]
    tag = f"uni_{loss}_{int(joint)}"
    np.testing.assert_array_equal(out[0][f"{tag}_x"], out[1][f"{tag}_x"])
    _close(out[0][f"{tag}_x"], jstate.x, "x")
    assert int(out[0][f"{tag}_count"]) == int(jstate.count) > 1
    for name in UniversalMetrics._fields:
        _close(out[0][f"{tag}_{name}"], getattr(jm, name), name)
        np.testing.assert_array_equal(out[0][f"{tag}_{name}"],
                                      out[1][f"{tag}_{name}"])
    pred = np.concatenate([out[0][f"{tag}_pred"], out[1][f"{tag}_pred"]])
    _close(pred, jpred, "flow_pred")
    assert float(np.abs(out[0][f"{tag}_x"]).max()) > 0


def _model_tree(name, rng_seed=0):
    """A JAX parameter tree of `name` (2 iterations, 2 levels) at 64×64,
    filled from a seed: LeCun-scaled kernels, small nonzero 1-D leaves,
    the flow head's conv2 damped ×0.01, GMA's gamma 0.5."""
    from pcfa_tpu.models import make_model as jmake_model

    jmodel, _ = jmake_model(name, iters=2, corr_levels=2)
    x = jnp.zeros((1, MH, MW, 3))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x,
                            x)["params"]
    rng = np.random.default_rng(rng_seed)

    def fill(s):
        if len(s.shape) == 4:  # HWIO: fan-in = kh·kw·I
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:3]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    tree = jax.tree.map(fill, shapes)
    ub = tree["update_block"]
    head = ub["flow_head"]["conv2"]
    head["kernel"], head["bias"] = 0.01 * head["kernel"], 0.01 * head["bias"]
    if name == "GMA":
        ub["aggregator"]["gamma"] = np.full((1,), 0.5, np.float32)
    return tree


@pytest.fixture(scope="module")
def models(spawned):
    """The 'models' ranks' results, and the serial JAX models' flows and
    input gradients of Σ flow_up·g in float64, and the port's unsplit PCFA
    run."""
    from pcfa_tpu.models import make_model as jmake_model
    from pcfa_tpu_torch.attack.pcfa import PCFAConfig, pcfa_attack
    from pcfa_tpu_torch.models import make_model

    d = spawned["models"]
    i1, i2, g, trees = d["i1"], d["i2"], d["g"], d["trees"]
    folder = spawned["folders"]["models"]
    ref = {}
    with jax.enable_x64(True):
        for case, (name, extra) in MODEL_CASES.items():
            jmodel, _ = jmake_model(name, iters=2, corr_levels=2, **extra)
            p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             trees[name])

            def loss(a, b, jmodel=jmodel, p=p):
                up = jmodel.apply({"params": p}, a, b)[1]
                return jnp.sum(up * g), up

            (_, up), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(jnp.asarray(i1),
                                                     jnp.asarray(i2))
            ref[case] = [np.asarray(v) for v in (up, *grads)]
    model, _ = make_model("RAFT", iters=2, corr_levels=2)
    model.load_state_dict(torch.load(folder / "raft.pt"))
    model = model.double().eval().requires_grad_(False)
    one = pcfa_attack(lambda a, b: model(a, b)[1], torch.from_numpy(i1),
                      torch.from_numpy(i2), torch.zeros(1, MH, MW, 2,
                                                        dtype=torch.float64),
                      PCFAConfig(steps=1, max_iter=2), device="cpu")
    ref["pcfa"] = [_np(v) for v in _leaves(one)]
    return dict(out=spawned["ranks"]["models"].wait(), ref=ref)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_row_sharded_model_matches_serial_jax(models, case):
    """flow_up and d image1, d image2 of Σ flow_up·g on each of the 2
    ranks against the serial JAX model (float64, 1e-9)."""
    out, ref = models["out"], models["ref"][case]
    for r in range(2):
        for what, want in zip(("up", "d1", "d2"), ref):
            _close(out[r][f"{case}_{what}"], want, f"rank {r} {case} {what}")
    assert np.abs(ref[1]).max() > 1e-3   # the gradient is not trivial


def test_pcfa_engine_on_row_sharded_raft(models):
    """The PCFA engine (1 step × max_iter 2) on the split RAFT equals its
    run on the unsplit port RAFT, on both ranks."""
    out, ref = models["out"], models["ref"]["pcfa"]
    for r in range(2):
        for i, want in enumerate(ref):
            _close(out[r][f"pcfa_{i}"], want, f"rank {r} leaf {i}")


def test_row_sharding_refusals(models):
    """H/8 = 9 rows do not split over 2 ranks; 'hybrid' is refused."""
    for r in range(2):
        rows = str(models["out"][r]["err_rows"])
        assert rows.startswith("ValueError") and "H/8=9" in rows, rows
        hybrid = str(models["out"][r]["err_hybrid"])
        assert hybrid.startswith("NotImplementedError") \
            and "'hybrid'" in hybrid, hybrid


def _run_metrics(folder):
    runs = glob.glob(os.path.join(str(folder), "*", "*"))
    assert len(runs) == 1, runs
    with open(os.path.join(runs[0], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return sorted(rows, key=lambda m: (m["step"], m["key"]))


@pytest.fixture(scope="module")
def cli(spawned):
    """The 'cli' ranks' runs, and the same two runs in one process: per
    pair with 3 pairs, universal with the global batch (2) in one batch."""
    from pcfa_tpu_torch.cli import attack_pcfa

    folder = spawned["folders"]["cli"]
    saved = dict(os.environ)
    try:
        os.environ.update(SPY_ENV, PCFA_SYNTHETIC_COUNT="3")
        attack_pcfa.main([*CLI_ARGS, "--pairs_per_device=1",
                          f"--output_folder={folder / 'one_pairs'}"],
                         device="cpu")
        os.environ["PCFA_SYNTHETIC_COUNT"] = "2"
        attack_pcfa.main([*CLI_ARGS, "--universal_perturbation",
                          "--batch_size=2", "--epochs=1", "--steps=1",
                          f"--output_folder={folder / 'one_uni'}"],
                         device="cpu")
    finally:
        os.environ.clear()
        os.environ.update(saved)
    spawned["ranks"]["cli"].wait()
    return folder


@pytest.mark.parametrize("branch,tol", [("pairs", 1e-12), ("uni", 1e-5)])
def test_cli_over_two_ranks_matches_one_process(cli, branch, tol):
    """Rank 0 writes the one run folder; its metrics, sorted by step,
    equal the one-process run's. Per pair every pair is attacked alone in
    both runs, so only the averages' order of summation differs (1e-12).
    Universal: float32, and the global loss and gradient are sums of the
    two ranks' in one run and of one batch in the other, which moves the
    L-BFGS trajectory by float32 rounding (3.5e-7 at most on this CPU;
    1e-5)."""
    got, want = _run_metrics(cli / f"dp_{branch}"), \
        _run_metrics(cli / f"one_{branch}")
    assert [(m["step"], m["key"]) for m in got] == \
        [(m["step"], m["key"]) for m in want]
    np.testing.assert_allclose([m["value"] for m in got],
                               [m["value"] for m in want], rtol=tol,
                               atol=tol)
    if branch == "pairs":   # every pair of the 3, under its dataset index
        assert {m["value"] for m in got if m["key"] == "batch"} == {0, 1, 2}


# ------------------------------------------------------ one process ---

def test_border_clamp_derivative_on_the_edge_matches_jax(monkeypatch):
    """`grid_sample` in border mode at grid points mapped exactly onto
    column 0 and onto row H − 1 (and one inside), float64: d grid equals
    `jax.grad` of `pcfa_tpu`'s, ½ of the slope inside on column 0 (where
    `torch.clamp` would give all of it). The JAX side samples through its
    float64 reference VJP (its packed one computes in float32)."""
    from pcfa_tpu.ops import warp as jwarp
    from pcfa_tpu_torch.ops import warp

    monkeypatch.setenv("PCFA_WARP_VJP", "reference")

    rng = np.random.default_rng(5)
    img = rng.standard_normal((1, 5, 6, 2))
    grid = np.array([[[[-1.0, 0.2], [0.3, 1.0], [-1.0, 1.0],
                       [-0.999, 0.2], [0.4, -0.3]]]])
    g = np.tile(rng.standard_normal(2), (1, 1, 5, 1))   # one per point
    tg = torch.from_numpy(grid).requires_grad_(True)
    out = warp.grid_sample(torch.from_numpy(img), tg, True, "border")
    (out * torch.from_numpy(g)).sum().backward()
    with jax.enable_x64(True):
        dg = jax.grad(lambda gr: jnp.sum(jwarp.grid_sample(
            jnp.asarray(img), gr, align_corners=True,
            padding_mode="border") * g))(jnp.asarray(grid))
    dg = np.asarray(dg)
    np.testing.assert_allclose(tg.grad.numpy(), dg, rtol=1e-12, atol=1e-12)
    # on column 0 the x-derivative is half the one just inside
    np.testing.assert_allclose(dg[0, 0, 0, 0], 0.5 * dg[0, 0, 3, 0],
                               rtol=1e-2)
    assert abs(dg[0, 0, 0, 0]) > 1e-3


@pytest.mark.parametrize("precision,tf32", [("highest", False),
                                            ("high", True),
                                            ("default", True)])
def test_runtime_config_maps_precision(monkeypatch, precision, tf32):
    """'highest' switches TF32 off for matmuls and cuDNN, 'high' and
    'default' on; PCFA_MATMUL_PRECISION overrides the field; debug_nans
    is autograd's anomaly mode; anything else raises."""
    from pcfa_tpu_torch import config

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.is_anomaly_enabled(),
             config._applied)
    try:
        monkeypatch.delenv("PCFA_MATMUL_PRECISION", raising=False)
        config.RuntimeConfig(precision, debug_nans=True).apply()
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.is_anomaly_enabled()
        monkeypatch.setenv("PCFA_MATMUL_PRECISION", "highest")
        config.RuntimeConfig(precision).apply()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.is_anomaly_enabled()
        monkeypatch.setenv("PCFA_MATMUL_PRECISION", "bfloat16")
        with pytest.raises(ValueError, match="bfloat16"):
            config.RuntimeConfig().apply()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.autograd.set_detect_anomaly(saved[2])
        config._applied = saved[3]


def test_available_models_match_jax():
    from pcfa_tpu.models.spec import available_models as javailable
    from pcfa_tpu_torch.models import available_models

    assert available_models() == javailable()


def test_parallel_names_match_jax():
    """Every public name of `pcfa_tpu.parallel` and of its modules has a
    counterpart of the same name in `pcfa_tpu_torch.parallel`."""
    import importlib
    import inspect

    for mod in ("", ".mesh", ".dp", ".multihost", ".sp"):
        jmod = importlib.import_module("pcfa_tpu.parallel" + mod)
        tmod = importlib.import_module("pcfa_tpu_torch.parallel" + mod)
        names = [n for n, v in vars(jmod).items() if not n.startswith("_")
                 and inspect.isfunction(v)
                 and (not mod or v.__module__ == jmod.__name__)]
        assert names
        missing = [n for n in names if not hasattr(tmod, n)]
        assert not missing, f"pcfa_tpu_torch.parallel{mod}: {missing}"
