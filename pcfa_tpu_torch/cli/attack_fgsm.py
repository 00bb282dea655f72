"""attack_FGSM CLI runner: I-FGSM over a dataset, pair by pair
(`pcfa_tpu/cli/attack_fgsm.py`).

    python -m pcfa_tpu_torch.cli.attack_fgsm --net=PWCNet --dataset=Kitti15 ...

`main(argv, device="cuda")` runs on the card and raises where there is
none; tests pass `device="cpu"`.
"""

from __future__ import annotations

import torch

from pcfa_tpu_torch.attack.fgsm import FGSMConfig, FGSMMetrics, fgsm_attack
from pcfa_tpu_torch.cli import common
from pcfa_tpu_torch.cli.parsing import create_parser
from pcfa_tpu_torch.runtime import make_flow_fn
from pcfa_tpu_torch.utils import tracking
from pcfa_tpu_torch.utils.tracking import (
    Tracker,
    save_flow,
    save_image,
    save_tensor,
)


def attack(args, device: str | torch.device = "cuda") -> dict:
    dev = common.setup_runtime(device)
    tracker = Tracker(args.output_folder, args.net, "FGSM",
                      args.joint_perturbation, False)

    print("\nStarting Fast Gradient Sign Method (FGSM) for Optical Flow:\n")
    print("\tModel:                   %s" % args.net)
    print("\tPerturbation universal:  False")
    print("\tPerturbation joint:      %s" % args.joint_perturbation)
    print()
    print("\tTarget:                  %s" % args.target)
    print("\tOptimizer steps:         %d" % args.steps)
    print("\tOptimizer stepsize:      %f" % args.epsilon)
    print()
    print("\tOutputfolder:            %s\n" % tracker.folder_path)

    cfg = FGSMConfig(
        steps=args.steps,
        epsilon=args.epsilon,
        loss=args.loss,
        joint_perturbation=args.joint_perturbation,
    )
    loader, has_gt = common.make_loader(args, batch_size=1)
    loaded = common.load_attack_model(args, dev)

    flow_fn = None
    sums = {k: 0.0 for k in (
        "aee_gt", "aee_tgt", "aee_gt_tgt", "aee_adv_gt", "aee_adv_tgt",
        "aee_adv_pred", "l2_delta12",
    )}
    tests = 0

    with tracker:
        tracker.log_params(
            outputfolder=tracker.folder_path,
            model=args.net,
            dataset=args.dataset,
            dataset_stage=args.dataset_stage,
            dstype=args.dstype,
            attack="FGSM",
            attack_loss=args.loss,
            attack_target=args.target,
            attack_joint=args.joint_perturbation,
            attack_universal=False,
            fgsm_eps=args.epsilon,
            optimizer="FGSM",
            optimizer_boxconstraint="clipping",
            optimizer_lr=args.epsilon,
            optimizer_steps=args.steps,
        )
        patches = tracking.create_subfolder(tracker.folder_path, "patches")
        kw = dict(tracker=tracker, register=not args.unregistered_artifacts)

        for batch, (img1, img2, flow_gt, _valid) in enumerate(
                common.progress(loader)):
            x1, x2 = common.unit_images(img1, img2, dev)
            if flow_fn is None:
                padder, flow_fn = make_flow_fn(
                    loaded, x1.shape[1:3], common.pad_mode_for(args.dataset))
            p1, p2 = padder.pad(x1, x2)

            with torch.no_grad():
                flow_pred_init = flow_fn(p1, p2)
            target = common.build_target(args, flow_pred_init)

            curr = batch * args.steps
            aee_tgt = common.epe(target, flow_pred_init)
            aee_gt_tgt = common.epe(target, flow_gt) if has_gt else None
            aee_gt = common.epe(flow_pred_init, flow_gt) if has_gt else None
            tracker.log_metrics(curr, ("batch", batch), ("steps", 0),
                                ("aee_pred-tgt", aee_tgt),
                                ("aee_gt-tgt", aee_gt_tgt),
                                ("aee_pred-gt", aee_gt))

            res = fgsm_attack(flow_fn, p1, p2, target, cfg, device=dev)
            # one pair: the engine's (1, steps) metrics as (steps,)
            m = FGSMMetrics(*(a[0] for a in common.host_metrics(
                res.metrics, FGSMMetrics)))
            for s in range(args.steps):
                cs = batch * args.steps + s
                tracker.log_metrics(
                    cs,
                    ("aee_predadv-tgt", m.aee_adv_tgt[s]),
                    ("aee_pred-predadv", m.aee_adv_pred[s]),
                    ("l2_delta1", m.l2_delta1[s]),
                    ("l2_delta2", m.l2_delta2[s]),
                    ("l2_delta-avg", m.l2_delta12[s]),
                )
            aee_adv_gt = common.epe(res.flow_pred, flow_gt) if has_gt else None
            if has_gt:
                tracker.log_metric("aee_predadv-gt", aee_adv_gt,
                                   (batch + 1) * args.steps - 1)

            if common.should_save(batch, args):
                save_tensor(res.delta1, "delta1_final", batch, patches, **kw)
                save_tensor(res.delta2, "delta2_final", batch, patches, **kw)
                save_tensor(p1, "image1", batch, patches, **kw)
                save_tensor(p2, "image2", batch, patches, **kw)
                save_tensor(target, "target", batch, patches, **kw)
                save_tensor(res.flow_pred, "flow_pred_final", batch, patches,
                            **kw)
                save_tensor(res.flow_pred_init, "flow_pred_init", batch,
                            patches, **kw)
                if has_gt:
                    save_tensor(flow_gt, "flow_gt", batch, patches, **kw)
                save_image(p1, batch, patches, image_name="image1", **kw)
                save_image(p2, batch, patches, image_name="image2", **kw)
                # the largest signed value, as the JAX CLI takes it
                max_delta = max(float(res.delta1.max()),
                                float(res.delta2.max()))
                save_image(res.delta1, batch, patches, image_name="delta1",
                           normalize_max=max_delta or None, **kw)
                if not args.joint_perturbation:
                    save_image(res.delta2, batch, patches,
                               image_name="delta2",
                               normalize_max=max_delta or None, **kw)
                mf = tracking.max_flow_length(
                    flow_gt if has_gt else None,
                    res.flow_pred_init, res.flow_pred,
                )
                fkw = dict(auto_scale=False, max_scale=mf, **kw)
                save_flow(res.flow_pred, batch, patches,
                          flow_name="flow_pred_final", **fkw)
                save_flow(res.flow_pred_init, batch, patches,
                          flow_name="flow_pred_init", **fkw)
                save_flow(target, batch, patches, flow_name="flow_target",
                          **fkw)
                if has_gt:
                    save_flow(flow_gt, batch, patches, flow_name="flow_gt",
                              **fkw)

            last = args.steps - 1
            sums["aee_tgt"] += aee_tgt
            sums["aee_adv_tgt"] += float(m.aee_adv_tgt[last])
            sums["aee_adv_pred"] += float(m.aee_adv_pred[last])
            sums["l2_delta12"] += float(m.l2_delta12[last])
            if has_gt:
                sums["aee_gt"] += aee_gt
                sums["aee_gt_tgt"] += aee_gt_tgt
                sums["aee_adv_gt"] += aee_adv_gt
            tests += 1

        averages = tracker.log_averages(
            tests,
            ("aee_avg_pred-gt", sums["aee_gt"] if has_gt else None),
            ("aee_avg_pred-tgt", sums["aee_tgt"]),
            ("aee_avg_gt-tgt", sums["aee_gt_tgt"] if has_gt else None),
            ("aee_avg_predadv-gt", sums["aee_adv_gt"] if has_gt else None),
            ("aee_avg_predadv-tgt", sums["aee_adv_tgt"]),
            ("aee_avg_pred-predadv", sums["aee_adv_pred"]),
            ("l2_avg_delta12", sums["l2_delta12"]),
        )

    print("\nFinished attacking with FGSM. The best achieved values are")
    print("\tAEE(f_adv, f_init)=%f" % (sums["aee_adv_pred"] / tests))
    print("\tAEE(f_adv, f_targ)=%f" % (sums["aee_adv_tgt"] / tests))
    print("\tL2(perturbation)  =%f" % (sums["l2_delta12"] / tests))
    print()
    return averages


def main(argv=None, device: str | torch.device = "cuda"):
    parser = create_parser(stage="training", attack_type="fgsm")
    args = parser.parse_args(argv)
    print(args)
    return attack(args, device)


if __name__ == "__main__":
    main()
