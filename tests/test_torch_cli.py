"""The port's CLIs (`pcfa_tpu_torch.cli`) against `pcfa_tpu.cli` on the CPU.

- The parsers: every default of every stage and attack type, and a full
  command line.
- The plumbing: both packages' `attack_pcfa` (per image and universal) and
  `attack_fgsm` run on SpyNet at 64×64, loading the same weight directory
  (the reference's layout) through `--checkpoint`, with the attack engine
  of both replaced by one numpy-seeded stub, so that what is compared is
  the host logic: the same artifact files, the same metric keys and steps,
  engine values equal, and the host's own EPEs equal to float32 summation
  order over 4,096 pixels (1e-4) where they come from the stub's flows and
  the ground truth and within 1e-3 where they come from the network's
  clean flow; the same
  `params.json`; `.npy` artifacts equal (the network's `flow_pred_init`
  within 1e-3) and PNGs with the same pixels.
- A δ written by either package's universal CLI, evaluated by the other's
  `evaluate_pcfa` (forward only, float32) within 1e-3 relative.
- One real run of the port's CLI on the CPU (SpyNet, 64×64, one step).
The JAX CLIs see one device (`jax.devices` is narrowed for each test), so
that they attack one pair per call, as the port does with
`--pairs_per_device=1`.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from pcfa_tpu.attack import fgsm as jfgsm
from pcfa_tpu.attack import pcfa as jpcfa
from pcfa_tpu.attack import universal as juniversal
from pcfa_tpu.cli import attack_fgsm as jcli_fgsm
from pcfa_tpu.cli import attack_pcfa as jcli_pcfa
from pcfa_tpu.cli import evaluate_pcfa as jcli_eval
from pcfa_tpu.cli import parsing as jparsing
from pcfa_tpu.io import write_flo
from pcfa_tpu_torch.attack import fgsm, pcfa, universal
from pcfa_tpu_torch.cli import attack_fgsm as cli_fgsm
from pcfa_tpu_torch.cli import attack_pcfa as cli_pcfa
from pcfa_tpu_torch.cli import evaluate_pcfa as cli_eval
from pcfa_tpu_torch.cli import parsing

STEPS = 2
DATA = ["--net=SpyNet", "--dataset=Synthetic", "--dataset_stage=training",
        "--unregistered_artifacts"]
# host-computed EPEs; those of the network's clean flow (and of a target
# made from it) compare within 1e-3
HOST_EPE = {"aee_pred-tgt", "aee_gt-tgt", "aee_pred-gt", "aee_predadv-gt",
            "aee_avg_pred-tgt", "aee_avg_gt-tgt", "aee_avg_pred-gt",
            "aee_avg_predadv-gt"}
NET_EPE = {"aee_pred-tgt", "aee_pred-gt", "aee_avg_pred-tgt",
           "aee_avg_pred-gt"}
TARGET_EPE = {"aee_gt-tgt", "aee_avg_gt-tgt"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread while this module runs: the suite runs a
    pytest worker per core, and torch's default of a thread per core makes
    the workers contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_weight_dir(path, seed=0):
    """SpyNet's per-layer files in the reference's layout ('F' model, six
    levels, OIHW weights and biases)."""
    gen = torch.Generator().manual_seed(seed)
    path.mkdir(parents=True, exist_ok=True)
    chans = (8, 32, 64, 32, 16, 2)
    for lvl in range(1, 7):
        for j, (c_in, c_out) in enumerate(zip(chans, chans[1:]), 1):
            w = torch.randn((c_out, c_in, 7, 7), generator=gen)
            torch.save(w / (7 * np.sqrt(c_in)),
                       path / f"modelL{lvl}_F-{j}-weight.pth.tar")
            torch.save(0.1 * torch.randn(c_out, generator=gen),
                       path / f"modelL{lvl}_F-{j}-bias.pth.tar")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    _write_weight_dir(root / "spynet_weights")
    return root


# ----------------------------------------------------- the stub engine ---

def _stub(img_shape, flow_shape, steps, n_metrics, n_x=0):
    """The stub's numbers: 4 δs, 2 flows, (n_metrics, steps) metrics and a
    flat optimizer variable of n_x, from one fixed seed."""
    rng = np.random.default_rng(5)
    deltas = [(1e-3 * rng.standard_normal(img_shape)).astype(np.float32)
              for _ in range(4)]
    flows = [rng.standard_normal(flow_shape).astype(np.float32)
             for _ in range(2)]
    metrics = rng.random((n_metrics, steps)).astype(np.float32)
    x = (1e-3 * rng.standard_normal(n_x)).astype(np.float32)
    return deltas, flows, metrics, x


def _jax_pcfa(flow_fn, image1, image2, target, config):
    d, f, m, _ = _stub(image1.shape, target.shape, config.steps, 9)
    a = [jnp.asarray(v) for v in d + f]
    return jpcfa.PCFAResult(*a[:4], flow_fn(image1, image2), *a[4:],
                            jpcfa.PCFAMetrics(*map(jnp.asarray, m)))


def _port_pcfa(flow_fn, image1, image2, target, config, device="cuda"):
    d, f, m, _ = _stub(tuple(image1.shape), tuple(target.shape),
                       config.steps, 9)
    a = [torch.from_numpy(v) for v in d + f]
    with torch.no_grad():
        init = flow_fn(image1, image2)
    rows = (torch.from_numpy(np.tile(v, (image1.shape[0], 1))) for v in m)
    return pcfa.PCFAResult(*a[:4], init, *a[4:], pcfa.PCFAMetrics(*rows))


def _jax_universal(flow_fn, images1, images2, target, opt_state, config):
    _, f, m, x = _stub(images1.shape, target.shape, config.steps, 6,
                       opt_state.x.size)
    return (opt_state._replace(x=jnp.asarray(x)),
            juniversal.UniversalMetrics(*map(jnp.asarray, m)),
            flow_fn(images1, images2), jnp.asarray(f[0]))


def _port_universal(flow_fn, images1, images2, target, opt_state, config):
    _, f, m, x = _stub(tuple(images1.shape), tuple(target.shape),
                       config.steps, 6, opt_state.x.numel())
    with torch.no_grad():
        init = flow_fn(images1, images2)
    return (opt_state._replace(x=torch.from_numpy(x).reshape(1, -1)),
            universal.UniversalMetrics(*map(torch.from_numpy, m)), init,
            torch.from_numpy(f[0]))


def _jax_fgsm(flow_fn, image1, image2, target, config):
    d, f, m, _ = _stub(image1.shape, target.shape, config.steps, 6)
    return jfgsm.FGSMResult(jnp.asarray(d[0]), jnp.asarray(d[1]),
                            flow_fn(image1, image2), jnp.asarray(f[0]),
                            jfgsm.FGSMMetrics(*map(jnp.asarray, m)))


def _port_fgsm(flow_fn, image1, image2, target, config, device="cuda"):
    d, f, m, _ = _stub(tuple(image1.shape), tuple(target.shape),
                       config.steps, 6)
    with torch.no_grad():
        init = flow_fn(image1, image2)
    rows = (torch.from_numpy(np.tile(v, (image1.shape[0], 1))) for v in m)
    return fgsm.FGSMResult(torch.from_numpy(d[0]), torch.from_numpy(d[1]),
                           init, torch.from_numpy(f[0]),
                           fgsm.FGSMMetrics(*rows))


@pytest.fixture
def cli_env(weights, monkeypatch):
    """Synthetic 64×64 data, the weight directory, one JAX device and the
    stub engine in both packages' CLIs. Returns (root, --checkpoint)."""
    monkeypatch.chdir(weights)   # pcfa_tpu's msgpack cache lands here
    monkeypatch.setenv("PCFA_SYNTHETIC_COUNT", "3")
    monkeypatch.setenv("PCFA_SYNTHETIC_SIZE", "64x64")
    monkeypatch.setenv("PCFA_NO_MLFLOW", "1")
    for name in ("devices", "local_devices"):
        fn = getattr(jax, name)
        monkeypatch.setattr(jax, name,
                            lambda *a, _fn=fn, **k: _fn(*a, **k)[:1])
    for mod, attr, stub in (
            (jcli_pcfa, "pcfa_attack", _jax_pcfa),
            (cli_pcfa, "pcfa_attack", _port_pcfa),
            (jcli_pcfa, "universal_batch_attack", _jax_universal),
            (cli_pcfa, "universal_batch_attack", _port_universal),
            (jcli_fgsm, "fgsm_attack", _jax_fgsm),
            (cli_fgsm, "fgsm_attack", _port_fgsm)):
        monkeypatch.setattr(mod, attr, stub)
    return weights, f"--checkpoint={weights / 'spynet_weights'}"


def _run_folder(out):
    [run] = glob.glob(os.path.join(out, "*", "*"))
    return run


def _metrics(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tolerance(key, net_target):
    if key in NET_EPE or (net_target and key in TARGET_EPE):
        return 1e-3
    return 1e-4 if key in HOST_EPE else 0.0


def _compare_runs(port_run, jax_run, net_target):
    """Artifacts, metrics and params of two run folders (see the module
    docstring for the tolerances); `net_target`: the target is made from
    the network's clean flow."""
    pa, ja = (os.path.join(r, "patches") for r in (port_run, jax_run))
    names = sorted(os.listdir(pa))
    assert names == sorted(os.listdir(ja))
    for name in names:
        if name.endswith(".npy"):
            a, b = np.load(os.path.join(pa, name)), np.load(
                os.path.join(ja, name))
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if "flow_pred_init" in name or (net_target and "target" in name):
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            a, b = (np.asarray(Image.open(os.path.join(d, name)))
                    for d in (pa, ja))
            assert a.shape == b.shape, name
            # plots scaled by the clean flow's length may round one level
            np.testing.assert_allclose(a, b, atol=1 if "flow" in name else 0,
                                       err_msg=name)
    got, want = _metrics(port_run), _metrics(jax_run)
    assert [(m["key"], m["step"]) for m in got] == \
        [(m["key"], m["step"]) for m in want]
    for a, b in zip(got, want):
        tol = _tolerance(a["key"], net_target)
        np.testing.assert_allclose(a["value"], b["value"], rtol=tol,
                                   atol=0, err_msg=a["key"])
    params = []
    for run in (port_run, jax_run):
        with open(os.path.join(run, "params.json")) as f:
            p = json.load(f)
        assert p.pop("outputfolder", run) == run
        params.append(p)
    assert params[0] == params[1]
    return got


CASES = {
    "pcfa": (cli_pcfa.main, jcli_pcfa.main,
             ["--boxconstraint=clipping", "--target=neg_flow"]),
    "universal": (cli_pcfa.main, jcli_pcfa.main,
                  ["--universal_perturbation", "--batch_size=2",
                   "--epochs=2"]),
    "fgsm": (cli_fgsm.main, jcli_fgsm.main, []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax_under_a_stubbed_engine(cli_env, case):
    root, ckpt = cli_env
    port_main, jax_main, flags = CASES[case]
    argv = DATA + [ckpt, f"--steps={STEPS}"] + flags
    out = {}
    for name, main, kw in (("port", port_main, {"device": "cpu"}),
                           ("jax", jax_main, {})):
        out[name] = str(root / case / name)
        res = main(argv + [f"--output_folder={out[name]}"], **kw)
        if case != "universal":
            out[name + "_avg"] = res
    net_target = "--target=neg_flow" in flags
    metrics = _compare_runs(_run_folder(out["port"]),
                            _run_folder(out["jax"]), net_target)
    if case != "universal":
        avg_p, avg_j = out["port_avg"], out["jax_avg"]
        assert avg_p.keys() == avg_j.keys()
        for k in avg_p:
            tol = _tolerance(k, net_target)
            np.testing.assert_allclose(avg_p[k], avg_j[k], rtol=tol, atol=0,
                                       err_msg=k)
    # 3 pairs × STEPS; universal: per epoch a full batch of 2, then the
    # ragged one, dropped (batch counters 0 and 2 of 0..3 log steps)
    want = ({0, 1, 4, 5} if case == "universal" else set(range(3 * STEPS)))
    assert {m["step"] for m in metrics} == want


def test_delta_evaluates_across_packages(cli_env):
    """Each package's universal CLI writes its δ; the other package's
    evaluator replays it. Both read the same δ (the stub's), so their
    results and metrics agree within 1e-3."""
    root, ckpt = cli_env
    runs = {}
    for name, main, kw in (("port", cli_pcfa.main, {"device": "cpu"}),
                           ("jax", jcli_pcfa.main, {})):
        out = str(root / "xeval" / name)
        runs[name] = main(DATA + [
            ckpt, "--steps=1", "--epochs=1", "--batch_size=2",
            "--universal_perturbation", f"--output_folder={out}"],
            **kw)["folder_path"]
    common = DATA + [ckpt, "--origin_net=SpyNet", "--universal_perturbation",
                     "--batch_size=2"]
    res, evals = {}, {}
    for name, main, src, kw in (
            ("port", cli_eval.main, runs["jax"], {"device": "cpu"}),
            ("jax", jcli_eval.main, runs["port"], {})):
        out = str(root / "xeval" / f"{name}_eval")
        res[name] = main(common + [f"--perturbation_sourcefolder={src}",
                                   f"--output_folder={out}"], **kw)
        evals[name] = _run_folder(out)
    assert res["port"].keys() == res["jax"].keys() == {0}
    for k in ("aee_adv_pred", "l2_delta12"):
        np.testing.assert_allclose(res["port"][0][k], res["jax"][0][k],
                                   rtol=1e-3, err_msg=k)
    got, want = _metrics(evals["port"]), _metrics(evals["jax"])
    assert [(m["key"], m["step"]) for m in got] == \
        [(m["key"], m["step"]) for m in want]
    np.testing.assert_allclose([m["value"] for m in got],
                               [m["value"] for m in want], rtol=1e-3)
    assert sorted(os.listdir(os.path.join(evals["port"], "patches"))) == \
        sorted(os.listdir(os.path.join(evals["jax"], "patches")))


def test_universal_resume_matches_jax(cli_env, monkeypatch):
    """`--resume_from` warm-starts the universal optimizer from a δ1
    snapshot and the δ2 beside it: the variable the engine first receives
    is the JAX CLI's construction from the same files (its
    `load_delta_nhwc`, δ1 then δ2, flattened)."""
    root, ckpt = cli_env
    rng = np.random.default_rng(3)
    snap = root / "snapshot"
    snap.mkdir(exist_ok=True)
    for k in (1, 2):
        np.save(snap / f"00007_delta{k}_e3.npy",
                rng.standard_normal((3, 64, 64)).astype(np.float32))
    seen = []

    def recording(flow_fn, images1, images2, target, opt_state, config):
        seen.append(opt_state.x.numpy().copy())
        return _port_universal(flow_fn, images1, images2, target, opt_state,
                               config)

    monkeypatch.setattr(cli_pcfa, "universal_batch_attack", recording)
    path = str(snap / "00007_delta1_e3.npy")
    cli_pcfa.main(DATA + [ckpt, "--steps=1", "--epochs=1", "--batch_size=2",
                          "--universal_perturbation", f"--resume_from={path}",
                          f"--output_folder={root / 'resume'}"],
                  device="cpu")
    want = np.concatenate([jcli_eval.load_delta_nhwc(path).ravel(),
                           jcli_eval.load_delta_nhwc(
                               path.replace("delta1", "delta2")).ravel()])
    assert seen[0].shape == (1, want.size)
    np.testing.assert_array_equal(seen[0][0], want)


# ------------------------------------------------------------- parser ---

@pytest.mark.parametrize("stage", ["training", "evaluation"])
@pytest.mark.parametrize("attack", ["pcfa", "fgsm"])
def test_parser_defaults_match_jax(stage, attack):
    port = parsing.create_parser(stage=stage, attack_type=attack)
    ref = jparsing.create_parser(stage=stage, attack_type=attack)
    assert vars(port.parse_args([])) == vars(ref.parse_args([]))


def test_parser_flags_match_jax():
    argv = ["--net=RAFT", "--dataset=Sintel", "--dstype=clean",
            "--joint_perturbation", "--pairs_per_device=4", "--steps=7",
            "--boxconstraint=clipping", "--delta_bound=0.01", "--mu=5",
            "--target=custom", "--custom_target_path=t.flo", "--loss=cosim",
            "--resume_from=d.npy", "--no_save", "--small_run"]
    port = parsing.create_parser("Training", "PCFA")
    ref = jparsing.create_parser("Training", "PCFA")
    assert vars(port.parse_args(argv)) == vars(ref.parse_args(argv))
    with pytest.raises(SystemExit):
        port.parse_args(["--net=NoNet"])
    with pytest.raises(ValueError):
        parsing.create_parser("testing", "pcfa")


# ----------------------------------------------------------- real run ---

def test_port_cli_end_to_end_on_cpu(weights, tmp_path, monkeypatch):
    """The port's `attack_pcfa` with its real engine on the CPU: SpyNet at
    64×64, one step, 3 pairs at 2 per call (the last call one pair: the
    ragged tail runs short), a custom target file larger than the frames
    (cropped). Every per-step metric is logged for every pair and finite,
    the best-δ latch takes the first step's δ (every norm is below the
    initial ∞), the artifacts have the reference's layout; then the
    evaluator replays the universal δ of a one-step universal run."""
    monkeypatch.setenv("PCFA_SYNTHETIC_COUNT", "3")
    monkeypatch.setenv("PCFA_SYNTHETIC_SIZE", "64x64")
    monkeypatch.setenv("PCFA_NO_MLFLOW", "1")
    tgt = np.zeros((80, 80, 2), np.float32)
    tgt[..., 0] = 3.0
    write_flo(tgt, str(tmp_path / "tgt.flo"))
    ckpt = f"--checkpoint={weights / 'spynet_weights'}"
    out = str(tmp_path / "pcfa")
    avgs = cli_pcfa.main(DATA + [
        ckpt, "--steps=1", "--boxconstraint=clipping", "--target=custom",
        f"--custom_target_path={tmp_path / 'tgt.flo'}",
        "--pairs_per_device=2", f"--output_folder={out}"], device="cpu")
    run = _run_folder(out)
    assert all(np.isfinite(v) for v in avgs.values())
    metrics = _metrics(run)
    per_step = [m for m in metrics if m["key"] == "l2_delta-avg_min"]
    assert [m["step"] for m in per_step] == [0, 1, 2]
    assert all(np.isfinite(m["value"]) for m in metrics)
    assert [m["value"] for m in per_step] == [
        m["value"] for m in metrics if m["key"] == "l2_delta-avg"]
    patches = os.path.join(run, "patches")
    for pair in range(3):
        d1 = np.load(os.path.join(patches, f"{pair:05d}_delta1_best.npy"))
        assert d1.shape == (1, 3, 64, 64)
        t = np.load(os.path.join(patches, f"{pair:05d}_target.npy"))
        np.testing.assert_array_equal(t[0, 0], 3.0)
        img = Image.open(os.path.join(patches, f"{pair:05d}_flow_gt.png"))
        assert img.size == (64, 64) and img.mode == "RGB"

    uni = str(tmp_path / "uni")
    folder = cli_pcfa.main(DATA + [
        ckpt, "--steps=1", "--epochs=1", "--batch_size=2",
        "--universal_perturbation", f"--output_folder={uni}"],
        device="cpu")["folder_path"]
    res = cli_eval.main(DATA + [
        ckpt, "--origin_net=SpyNet", "--universal_perturbation",
        "--batch_size=2", f"--perturbation_sourcefolder={folder}",
        f"--output_folder={tmp_path / 'eval'}"], device="cpu")
    assert np.isfinite(res[0]["aee_adv_pred"])


def test_port_cli_entry_points_default_to_the_card(tmp_path):
    """`main(argv)` asks for CUDA; without it, it raises before writing
    anything (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    argv = DATA + ["--steps=1", f"--output_folder={tmp_path / 'o'}"]
    for main, extra in ((cli_pcfa.main, []), (cli_fgsm.main, []),
                        (cli_eval.main, ["--universal_perturbation",
                                         "--origin_net=SpyNet",
                                         "--perturbation_sourcefolder=x"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + extra)
    assert not (tmp_path / "o").exists()
    with pytest.raises(ValueError):
        cli_eval.main(DATA + ["--origin_net=SpyNet",
                              "--perturbation_sourcefolder=x"],
                      device="cpu")
