"""attack_PCFA CLI runner: per-image and universal PCFA
(`pcfa_tpu/cli/attack_pcfa.py`).

    python -m pcfa_tpu_torch.cli.attack_pcfa --net=RAFT --dataset=Kitti15 ...

Host-side orchestration around the engines (`attack/pcfa.py`,
`attack/universal.py`): data loading, target construction, metric logging
with the reference vocabulary, artifact writing with the reference
naming. Every metric key, step index, average, `params.json` entry and
artifact is the JAX CLI's.

`main(argv, device="cuda")` runs on the card and raises where there is
none; tests pass `device="cpu"`. `--pairs_per_device=N` attacks N pairs
at once as one batch on each device (the engine keeps them
independent); the last batch of a dataset runs short. Calls are eager:
one flow function per run, built at the first batch's size. Started as
several processes (`torchrun`, `parallel/multihost.py`), both branches
split the dataset over the ranks, one device each, and rank 0 writes
the run's one folder.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from pcfa_tpu_torch import config
from pcfa_tpu_torch.attack.losses import default_mu
from pcfa_tpu_torch.attack.pcfa import PCFAConfig, PCFAMetrics, pcfa_attack
from pcfa_tpu_torch.attack.universal import (
    UniversalConfig,
    UniversalMetrics,
    universal_batch_attack,
    universal_init,
    unpack_deltas,
)
from pcfa_tpu_torch.cli import common
from pcfa_tpu_torch.cli.evaluate_pcfa import load_delta_nhwc
from pcfa_tpu_torch.cli.parsing import create_parser
from pcfa_tpu_torch.parallel.dp import (
    gather_pairs,
    global_mean_epe,
    universal_batch_attack_dp,
)
from pcfa_tpu_torch.parallel.mesh import (
    all_gather_object,
    all_reduce_min,
    data_mesh,
)
from pcfa_tpu_torch.runtime import make_flow_fn
from pcfa_tpu_torch.utils import tracking
from pcfa_tpu_torch.utils.tracking import (
    Tracker,
    save_flow,
    save_image,
    save_tensor,
)


def resolve_mu(args) -> float:
    if args.mu == -1.0:
        mu = default_mu(args.delta_bound, args.target)
        print(
            "The optimizer penalty factor mu was choosen automatically to "
            "%d, because no value was provided via --mu.\n" % mu
        )
        return mu
    return args.mu


def _banner(args, mu, folder_path, universal):
    print("\nStarting Perturbation Constrained Flow Attack (PCFA):\n")
    print("\tModel:                   %s" % args.net)
    print("\tPerturbation universal:  %s" % universal)
    print("\tPerturbation joint:      %s" % args.joint_perturbation)
    print("\tPerturbation bound:      %f" % args.delta_bound)
    print()
    print("\tTarget:                  %s" % args.target)
    print("\tOptimizer steps:         %d" % args.steps)
    print("\tOptimizer boxconstraint: %s"
          % ("clipping" if universal else args.boxconstraint))
    print("\tOptimizer mu:            %f" % mu)
    print()
    print("\tOutputfolder:            %s\n" % folder_path)


def _log_setup_params(tracker, args, mu, batch_size, epochs):
    tracker.log_params(
        outputfolder=tracker.folder_path,
        model=args.net,
        dataset=args.dataset,
        dataset_stage=args.dataset_stage,
        dstype=args.dstype,
        dataset_batchsize=batch_size,
        dataset_epochs=epochs,
        attack="PCFA",
        attack_loss=args.loss,
        attack_target=args.target,
        attack_joint=args.joint_perturbation,
        attack_universal=args.universal_perturbation,
        box_eps=1e-7,
        pcfa_delta_bound=args.delta_bound,
        optimizer="LBFGS",
        optimizer_mu=args.mu,
        optimizer_resolved_mu=mu,
        optimizer_boxconstraint=(
            "clipping" if args.universal_perturbation else args.boxconstraint
        ),
        optimizer_steps=args.steps,
    )


def attack_l2(args, device: str | torch.device = "cuda") -> dict:
    """Per-image (disjoint/joint) PCFA over a dataset. Over several ranks
    (`parallel/multihost.py`) each rank attacks the pairs of its slice of
    the dataset on its device, `--pairs_per_device` at a time; the results
    are gathered and rank 0 alone logs every pair under its dataset index
    and writes the run's one folder. Other ranks return {}."""
    dev = common.setup_runtime(device)
    mesh = data_mesh()
    main_rank = mesh.rank == 0
    mu = resolve_mu(args)
    tracker = Tracker(args.output_folder, args.net, "PCFA",
                      args.joint_perturbation, False) if main_rank else None
    if main_rank:
        _banner(args, mu, tracker.folder_path, universal=False)

    cfg = PCFAConfig(
        steps=args.steps,
        delta_bound=args.delta_bound,
        mu=mu,
        loss=args.loss,
        target=args.target,
        boxconstraint=args.boxconstraint,
        joint_perturbation=args.joint_perturbation,
        lbfgs_direction=config.lbfgs_direction(),
        lbfgs_history_dtype=config.lbfgs_history_dtype(args.net),
    )

    per_device = max(1, args.pairs_per_device)
    pair_chunk = mesh.size * per_device
    if pair_chunk > 1 and main_rank:
        print(f"Running {pair_chunk} per-image attacks in parallel "
              f"({per_device} per device × {mesh.size} device"
              f"{'s' if mesh.size > 1 else ''})\n")
    loader, has_gt = common.make_loader(args, batch_size=per_device)
    loaded = common.load_attack_model(args, dev)
    # each rank's first dataset index, and the batches every rank takes
    # part in: a rank whose slice has run out joins each gather empty
    sizes = all_gather_object(len(loader.dataset), mesh)
    starts = [sum(sizes[:r]) for r in range(mesh.size)]
    n_batches = max(-(-n // per_device) for n in sizes)

    flow_fn = None
    sums = {k: 0.0 for k in (
        "aee_gt", "aee_tgt", "aee_gt_tgt", "aee_adv_gt", "aee_adv_tgt",
        "aee_adv_pred", "l2_delta12", "aee_adv_tgt_min", "aee_adv_pred_min",
        "l2_delta12_min",
    )}
    tests = 0

    with tracker or contextlib.nullcontext():
        if main_rank:
            _log_setup_params(tracker, args, mu, 1, 1)
            patches = tracking.create_subfolder(tracker.folder_path,
                                                "patches")
        batches = iter(common.progress(loader))
        for batch in range(n_batches):
            local = None
            item = next(batches, None)
            if item is not None:
                img1, img2, flow_gt, _valid = item
                x1, x2 = common.unit_images(img1, img2, dev)
                if flow_fn is None:
                    padder, flow_fn = make_flow_fn(
                        loaded, x1.shape[1:3],
                        common.pad_mode_for(args.dataset))
                p1, p2 = padder.pad(x1, x2)

                with torch.no_grad():
                    flow_pred_init = flow_fn(p1, p2)
                target = common.build_target(args, flow_pred_init)
                res = pcfa_attack(flow_fn, p1, p2, target, cfg, device=dev)
                local = (res, p1, p2, target, flow_pred_init,
                         torch.from_numpy(flow_gt).to(dev))
            gathered, counts = gather_pairs(local, mesh, dev)
            if not main_rank:
                continue
            res, p1, p2, target, flow_pred_init, flow_gt = gathered
            m_all = common.host_metrics(res.metrics, PCFAMetrics)
            pairs = [starts[r] + batch * per_device + i
                     for r, n in enumerate(counts) for i in range(n)]

            for i, pair in enumerate(pairs):
                m = PCFAMetrics(*(a[i] for a in m_all))
                res_i = res._replace(**{
                    k: v[i:i + 1] for k, v in res._asdict().items()
                    if k != "metrics"})
                p1_i, p2_i = p1[i:i + 1], p2[i:i + 1]
                tgt_i = target[i:i + 1]
                fpi_i = flow_pred_init[i:i + 1]
                gt_i = flow_gt[i:i + 1]

                curr = pair * args.steps
                aee_tgt = common.epe(tgt_i, fpi_i)
                aee_gt_tgt = common.epe(tgt_i, gt_i) if has_gt else None
                aee_gt = common.epe(fpi_i, gt_i) if has_gt else None
                tracker.log_metrics(curr, ("aee_pred-tgt", aee_tgt),
                                    ("aee_gt-tgt", aee_gt_tgt),
                                    ("aee_pred-gt", aee_gt))
                tracker.log_metric("optim_mu", mu, curr)

                for st in range(args.steps):
                    cs = pair * args.steps + st
                    tracker.log_metrics(
                        cs,
                        ("batch", pair), ("steps", st), ("epoch", 0),
                        ("aee_predadv-tgt", m.aee_adv_tgt[st]),
                        ("aee_pred-predadv", m.aee_adv_pred[st]),
                        ("l2_delta1", m.l2_delta1[st]),
                        ("l2_delta2", m.l2_delta2[st]),
                        ("l2_delta-avg", m.l2_delta12[st]),
                        ("aee_pred-tgt_min", m.aee_adv_tgt_min[st]),
                        ("l2_delta-avg_min", m.l2_delta12_min[st]),
                        ("aee_pred-predadv_min", m.aee_adv_pred_min[st]),
                    )
                aee_adv_gt = (
                    common.epe(res_i.flow_pred, gt_i) if has_gt else None
                )
                if has_gt:
                    tracker.log_metric("aee_predadv-gt", aee_adv_gt,
                                       (pair + 1) * args.steps - 1)

                if common.should_save(pair, args):
                    _save_pair(args, tracker, patches, pair, res_i, p1_i,
                               p2_i, tgt_i, gt_i, has_gt)

                last = args.steps - 1
                sums["aee_tgt"] += aee_tgt
                sums["aee_adv_tgt"] += float(m.aee_adv_tgt[last])
                sums["aee_adv_pred"] += float(m.aee_adv_pred[last])
                sums["l2_delta12"] += float(m.l2_delta12[last])
                sums["aee_adv_tgt_min"] += float(m.aee_adv_tgt_min[last])
                sums["aee_adv_pred_min"] += float(m.aee_adv_pred_min[last])
                sums["l2_delta12_min"] += float(m.l2_delta12_min[last])
                if has_gt:
                    sums["aee_gt"] += aee_gt
                    sums["aee_gt_tgt"] += aee_gt_tgt
                    sums["aee_adv_gt"] += aee_adv_gt
                tests += 1

        if not main_rank:
            return {}
        averages = tracker.log_averages(
            tests,
            ("aee_avg_pred-gt", sums["aee_gt"] if has_gt else None),
            ("aee_avg_pred-tgt", sums["aee_tgt"]),
            ("aee_avg_gt-tgt", sums["aee_gt_tgt"] if has_gt else None),
            ("aee_avg_predadv-gt", sums["aee_adv_gt"] if has_gt else None),
            ("aee_avg_predadv-tgt", sums["aee_adv_tgt"]),
            ("aee_avg_pred-predadv", sums["aee_adv_pred"]),
            ("l2_avg_delta12", sums["l2_delta12"]),
            ("aee_avg_predadv-tgt_min", sums["aee_adv_tgt_min"]),
            ("aee_avg_pred-predadv_min", sums["aee_adv_pred_min"]),
            ("l2_avg_delta12_min", sums["l2_delta12_min"]),
        )

    print("\nFinished attacking with PCFA. The best achieved values are")
    print("\tAEE(f_adv, f_init)=%f" % (sums["aee_adv_pred_min"] / tests))
    print("\tAEE(f_adv, f_targ)=%f" % (sums["aee_adv_tgt_min"] / tests))
    print("\tL2(perturbation)  =%f" % (sums["l2_delta12_min"] / tests))
    print()
    return averages


def _save_pair(args, tracker, patches, pair, res_i, p1_i, p2_i, tgt_i, gt_i,
               has_gt):
    """One attacked pair's tensors, images and flow plots."""
    kw = dict(tracker=tracker, register=not args.unregistered_artifacts)
    for name, arr in (
            ("delta1_final", res_i.delta1), ("delta2_final", res_i.delta2),
            ("delta1_best", res_i.delta1_best),
            ("delta2_best", res_i.delta2_best),
            ("image1", p1_i), ("image2", p2_i), ("target", tgt_i),
            ("flow_pred_final", res_i.flow_pred),
            ("flow_pred_best", res_i.flow_pred_best),
            ("flow_pred_init", res_i.flow_pred_init)):
        save_tensor(arr, name, pair, patches, **kw)
    if has_gt:
        save_tensor(gt_i, "flow_gt", pair, patches, **kw)

    save_image(p1_i, pair, patches, image_name="image1", **kw)
    save_image(p2_i, pair, patches, image_name="image2", **kw)
    save_image(p1_i + res_i.delta1_best, pair, patches,
               image_name="image1_delta_best", **kw)
    save_image(p2_i + res_i.delta2_best, pair, patches,
               image_name="image2_delta_best", **kw)
    max_delta = max(float(res_i.delta1_best.abs().max()),
                    float(res_i.delta2_best.abs().max()))
    save_image(res_i.delta1_best, pair, patches, image_name="delta1_best",
               normalize_max=max_delta or None, **kw)
    if not args.joint_perturbation:
        save_image(res_i.delta2_best, pair, patches,
                   image_name="delta2_best",
                   normalize_max=max_delta or None, **kw)
    mf = tracking.max_flow_length(gt_i if has_gt else None,
                                  res_i.flow_pred_init, res_i.flow_pred_best)
    fkw = dict(auto_scale=False, max_scale=mf, **kw)
    save_flow(res_i.flow_pred_best, pair, patches, flow_name="flow_pred_best",
              **fkw)
    save_flow(res_i.flow_pred_init, pair, patches, flow_name="flow_pred_init",
              **fkw)
    save_flow(tgt_i, pair, patches, flow_name="flow_target", **fkw)
    if has_gt:
        save_flow(gt_i, pair, patches, flow_name="flow_gt", **fkw)


def _resume_x(path: str, cfg: UniversalConfig, device) -> torch.Tensor:
    """The universal optimizer's variable (1, n) from a per-epoch δ1
    snapshot (and its δ2 beside it in disjoint mode)."""
    parts = [load_delta_nhwc(path)]
    if not cfg.joint_perturbation:
        parts.append(load_delta_nhwc(path.replace("delta1", "delta2")))
    return torch.cat([torch.from_numpy(p).reshape(-1) for p in parts]
                     ).reshape(1, -1).to(device)


def attack_l2_universal(args, device: str | torch.device = "cuda") -> dict:
    """Universal-δ trainer: one δ (two in disjoint mode) for the whole
    dataset, its L-BFGS state carried over every batch of every epoch.
    A ragged last batch is dropped, as the JAX CLI drops it. Over several
    ranks the global batch is `--batch_size` × ranks, each rank's batch
    from its slice of the dataset (`parallel/dp.py`); the ranks agree each
    epoch on the number of full batches (their minimum), every logged
    metric is the global batch's, and rank 0 alone writes the run's
    folder (the per-epoch artifacts of the global batch)."""
    dev = common.setup_runtime(device)
    mesh = data_mesh()
    main_rank = mesh.rank == 0
    mu = resolve_mu(args)
    tracker = Tracker(args.output_folder, args.net, "PCFA",
                      args.joint_perturbation, True) if main_rank else None
    if main_rank:
        _banner(args, mu, tracker.folder_path, universal=True)

    cfg = UniversalConfig(
        steps=args.steps,
        delta_bound=args.delta_bound,
        mu=mu,
        loss=args.loss,
        joint_perturbation=args.joint_perturbation,
        lbfgs_direction=config.lbfgs_direction(),
        lbfgs_history_dtype=config.lbfgs_history_dtype(args.net),
    )

    loader, has_gt = common.make_loader(args, batch_size=args.batch_size,
                                        shuffle=True)
    loaded = common.load_attack_model(args, dev)
    if mesh.size == 1:
        epe, attack = common.epe, universal_batch_attack
    else:
        if main_rank:
            print(f"Sharding universal training over {mesh.size} ranks "
                  f"(axis 'data', backend {mesh.backend})")

        def epe(a, b):
            return float(global_mean_epe(a, b, mesh))

        attack = functools.partial(universal_batch_attack_dp, mesh=mesh)
    full = torch.tensor([len(loader.dataset) // args.batch_size],
                        device=dev)
    n_full = int(all_reduce_min(full, mesh)[0])

    flow_fn = None
    opt_state = None
    batch_ctr = -1

    with tracker or contextlib.nullcontext():
        if main_rank:
            _log_setup_params(tracker, args, mu, args.batch_size,
                              args.epochs)
            patches = tracking.create_subfolder(tracker.folder_path,
                                                "patches")
            kw = dict(tracker=tracker,
                      register=not args.unregistered_artifacts)

        for epoch in range(args.epochs):
            if main_rank:
                print("epoch: %d" % epoch)
            done = 0
            for batch, (img1, img2, flow_gt, _valid) in enumerate(
                    common.progress(loader)):
                batch_ctr += 1
                x1, x2 = common.unit_images(img1, img2, dev)
                flow_gt = torch.from_numpy(flow_gt).to(dev)
                if flow_fn is None:
                    padder, flow_fn = make_flow_fn(
                        loaded, x1.shape[1:3],
                        common.pad_mode_for(args.dataset))
                    delta_shape = padder.padded_shape + (3,)
                    opt_state = universal_init(delta_shape, cfg, device=dev)
                    if getattr(args, "resume_from", None):
                        opt_state = opt_state._replace(
                            x=_resume_x(args.resume_from, cfg, dev))
                        if main_rank:
                            print("Resumed universal delta from %s"
                                  % args.resume_from)
                p1, p2 = padder.pad(x1, x2)
                if p1.shape[0] != args.batch_size or done == n_full:
                    continue

                with torch.no_grad():
                    flow_pred_init = flow_fn(p1, p2)
                target = common.build_target(args, flow_pred_init)

                curr = batch_ctr * args.steps
                logged = [("aee_pred-tgt", epe(target, flow_pred_init)),
                          ("aee_gt-tgt",
                           epe(target, flow_gt) if has_gt else None),
                          ("aee_pred-gt",
                           epe(flow_pred_init, flow_gt) if has_gt else None)]
                opt_state, metrics, _, flow_pred = attack(
                    flow_fn, p1, p2, target, opt_state, cfg)
                done += 1
                last = (p1, p2, target, flow_pred, flow_pred_init, flow_gt)
                aee_adv_gt = epe(flow_pred, flow_gt) if has_gt else None
                d1, d2 = unpack_deltas(opt_state.x[0], delta_shape,
                                       cfg.joint_perturbation)
                if not main_rank:
                    continue
                tracker.log_metrics(curr, *logged)
                m = common.host_metrics(metrics, UniversalMetrics)
                for s in range(args.steps):
                    cs = batch_ctr * args.steps + s
                    tracker.log_metrics(
                        cs,
                        ("steps", s), ("batch", batch), ("epoch", epoch),
                        ("aee_predadv-tgt", m.aee_adv_tgt[s]),
                        ("aee_pred-predadv", m.aee_adv_pred[s]),
                        ("l2_delta1", m.l2_delta1[s]),
                        ("l2_delta2", m.l2_delta2[s]),
                        ("l2_delta-avg", m.l2_delta12[s]),
                    )
                if has_gt:
                    tracker.log_metric("aee_predadv-gt", aee_adv_gt,
                                       (batch_ctr + 1) * args.steps - 1)
                if common.should_save(batch_ctr, args):
                    save_tensor(d1, f"delta1_b{batch_ctr}", batch_ctr,
                                patches, **kw)
                    save_tensor(d2, f"delta2_b{batch_ctr}", batch_ctr,
                                patches, **kw)

            # ---- per-epoch artifacts --------------------------------------
            if not done:
                raise ValueError(
                    f"no full batch of size {args.batch_size} in the "
                    f"dataset — reduce --batch_size (ragged batches are "
                    f"dropped: the universal δ optimizer state is shaped "
                    f"for full batches)"
                )
            if mesh.size > 1:
                # the global batch last attacked: images, targets, flows
                (p1, p2, target, flow_pred, flow_pred_init, flow_gt), _ = \
                    gather_pairs(last, mesh, dev)
            if not main_rank:
                continue
            save_tensor(d1, f"delta1_e{epoch}", batch_ctr, patches, **kw)
            max_delta = max(float(d1.abs().max()), float(d2.abs().max()))
            save_image(d1, batch_ctr, patches, image_name=f"delta1_e{epoch}",
                       normalize_max=max_delta or None, **kw)
            if not args.joint_perturbation:
                save_tensor(d2, f"delta2_e{epoch}", batch_ctr, patches, **kw)
                save_image(d2, batch_ctr, patches,
                           image_name=f"delta2_e{epoch}",
                           normalize_max=max_delta or None, **kw)
            save_image(p1 + d1[None], batch_ctr, patches,
                       image_name=f"image1_delta_e{epoch}", **kw)
            save_image(p2 + d2[None], batch_ctr, patches,
                       image_name=f"image2_delta_e{epoch}", **kw)
            mf = tracking.max_flow_length(
                flow_gt if has_gt else None, flow_pred_init, flow_pred)
            save_flow(flow_pred, batch_ctr, patches,
                      flow_name=f"flow_pred_e{epoch}",
                      auto_scale=False, max_scale=mf, **kw)
            if epoch == 0:
                save_tensor(p1, "image1_e0", batch, patches, **kw)
                save_tensor(p2, "image2_e0", batch, patches, **kw)
                save_tensor(target, "target_e0", batch, patches, **kw)
                save_tensor(flow_pred, "flow_pred_e0", batch, patches, **kw)
                save_tensor(flow_pred_init, "flow_pred_init_e0", batch,
                            patches, **kw)
                if has_gt:
                    save_tensor(flow_gt, "flow_gt_e0", batch, patches, **kw)
                save_image(p1, batch, patches, image_name="image1", **kw)
                save_image(p2, batch, patches, image_name="image2", **kw)
                save_flow(target, batch, patches, flow_name="flow_target",
                          auto_scale=False, max_scale=mf, **kw)
                save_flow(flow_pred_init, batch, patches,
                          flow_name="flow_pred_init",
                          auto_scale=False, max_scale=mf, **kw)
                if has_gt:
                    save_flow(flow_gt, batch, patches, flow_name="flow_gt",
                              auto_scale=False, max_scale=mf, **kw)

    if not main_rank:
        return {}
    print(
        "\nFinished attacking with PCFA, universal perturbations have been "
        "produced and are logged at\n%s" % tracker.folder_path
    )
    print(
        "To evaluate: python3 -m pcfa_tpu_torch.cli.evaluate_pcfa --net=%s "
        "--origin_net=%s --dataset=%s --dataset_stage=%s "
        "--perturbation_sourcefolder=%s --dstype=%s --universal_perturbation "
        "--boxconstraint=clipping %s\n"
        % (args.net, args.net, args.dataset, args.dataset_stage,
           tracker.folder_path, args.dstype,
           "--joint_perturbation" if args.joint_perturbation else "")
    )
    return {"folder_path": tracker.folder_path}


def main(argv=None, device: str | torch.device = "cuda"):
    parser = create_parser(stage="training", attack_type="pcfa")
    args = parser.parse_args(argv)
    print(args)
    if args.universal_perturbation:
        return attack_l2_universal(args, device)
    return attack_l2(args, device)


if __name__ == "__main__":
    main()
