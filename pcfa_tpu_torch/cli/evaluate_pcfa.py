"""evaluate_PCFA CLI runner: replay or transfer evaluation of trained δ
(`pcfa_tpu/cli/evaluate_pcfa.py`).

    python -m pcfa_tpu_torch.cli.evaluate_pcfa --net=RAFT --origin_net=SpyNet \
        --universal_perturbation --perturbation_sourcefolder=<run folder>

Loads `.npy` perturbations (one file, or a run folder's `patches/` with
`{batch:05d}_delta{1,2}_e{epoch}.npy`), written by either package,
re-pads them for the evaluation network when the padding families differ,
replays them over a dataset without gradients, and reports AEE(f_adv,
f_init) per epoch. `main(argv, device="cuda")` runs on the card and
raises where there is none; tests pass `device="cpu"`.

The reference re-pads through its image preprocessing, which divides by
255 and multiplies back for unit-input nets; here, in unit scale
throughout, unpad then re-pad has the same net effect.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from pcfa_tpu_torch.attack.boxconstraint import clip01
from pcfa_tpu_torch.attack.losses import two_norm_avg, two_norm_avg_delta
from pcfa_tpu_torch.cli import common
from pcfa_tpu_torch.cli.parsing import create_parser
from pcfa_tpu_torch.runtime import make_flow_fn
from pcfa_tpu_torch.utils import tracking
from pcfa_tpu_torch.utils.padder import InputPadder
from pcfa_tpu_torch.utils.tracking import (
    Tracker,
    save_flow,
    save_image,
    save_tensor,
)

PAD_FAMILY = {
    "PWCNet": 64, "SpyNet": 64, "FlowNet2": 64, "RAFT": 8, "GMA": 8,
}


def extract_epoch_patchlist(path: str):
    """(epochs, δ1 paths, δ2 paths) of a `.npy` file or a run folder."""
    delta1_list: list[str] = []
    delta2_list: list[str] = []
    print("Loading existing perturbation(s) from\n%s" % path)
    if os.path.isfile(path):
        if os.path.splitext(path)[1] != ".npy":
            raise ValueError(
                "Invalid extension %s for perturbation file, please use a "
                ".npy file instead of %s" % (os.path.splitext(path)[1], path)
            )
        print("\tFound path to a perturbation file. Evaluating one "
              "perturbation (epochs=1) only.")
        return 1, [path], []

    base_folder = os.path.join(path, "patches")
    pattern1 = re.compile(r"[0-9]{5}_delta1_e[0-9]*.npy")
    pattern2 = re.compile(r"[0-9]{5}_delta2_e[0-9]*.npy")
    for file in os.listdir(base_folder):
        if pattern1.match(file):
            delta1_list.append(os.path.join(base_folder, file))
        if pattern2.match(file):
            delta2_list.append(os.path.join(base_folder, file))

    def epoch_of(p):
        return int(p.split("_")[-1].split(".")[0][1:])

    delta1_list = sorted(delta1_list, key=epoch_of)
    delta2_list = sorted(delta2_list, key=epoch_of)
    epochs = epoch_of(delta1_list[-1]) + 1
    print("\tFound path to folder that contains perturbation files from "
          "%d epochs. Evaluating each epoch perturbation." % epochs)
    return epochs, delta1_list, delta2_list


def load_delta_nhwc(path: str) -> np.ndarray:
    """δ artifacts are stored in reference NCHW/CHW layout → (H, W, C)."""
    d = np.load(path)
    if d.ndim == 4:
        d = d[0]
    return np.transpose(d, (1, 2, 0)).astype(np.float32)


def convert_perturbationsizes(
    delta_hwc: np.ndarray,
    image_hw: tuple[int, int],
    network_training: str,
    network_eval: str,
) -> np.ndarray:
    """Padding-family conversion: unpad with the training net's padder,
    re-pad (replicate) for the evaluation net; `delta_hwc` itself where
    both nets pad alike."""
    if PAD_FAMILY[network_training] == PAD_FAMILY[network_eval]:
        return delta_hwc
    print("Changing padding when importing perturbation trained for %s to "
          "evaluate it on %s" % (network_training, network_eval))
    padder_train = InputPadder(tuple(image_hw) + (3,),
                               divisor=PAD_FAMILY[network_training])
    unpadded = padder_train.unpad(delta_hwc)
    padder_eval = InputPadder(tuple(image_hw) + (3,),
                              divisor=PAD_FAMILY[network_eval])
    [repadded] = padder_eval.pad(unpadded)
    return np.asarray(repadded)


def eval_l2_universal(args, device: str | torch.device = "cuda") -> dict:
    dev = common.setup_runtime(device)
    tracker = Tracker(args.output_folder, args.net, "PCFA",
                      args.joint_perturbation, args.universal_perturbation,
                      stage="eval")

    print("Evaluating a Perturbation Constrained Flow Attack:\n")
    print("\tModel (evaluation, now): %s" % args.net)
    print("\tModel (training):        %s" % args.origin_net)
    print("\tPerturbation universal:  %s" % args.universal_perturbation)
    print("\tPerturbation joint:      %s" % args.joint_perturbation)
    print()
    print("\tOutputfolder:            %s\n" % tracker.folder_path)

    if args.origin_net is None:
        raise ValueError(
            "args.origin_net is not allowed to be empty. Please state which "
            "network was used to train the perturbations via the "
            "--origin_net argument."
        )

    epochs, delta1_paths, delta2_paths = extract_epoch_patchlist(
        args.perturbation_sourcefolder)
    loader, has_gt = common.make_loader(args, batch_size=args.batch_size)
    loaded = common.load_attack_model(args, dev)

    results = {}
    with tracker:
        tracker.log_params(
            perturbation_sourcefolder=args.perturbation_sourcefolder,
            stage="eval", outputfolder=tracker.folder_path,
            origin_net=args.origin_net, model=args.net,
            dataset=args.dataset, dataset_stage=args.dataset_stage,
            dataset_batchsize=args.batch_size, dataset_epochs=epochs,
            dstype=args.dstype,
            attack_joint_perturbation=args.joint_perturbation,
            attack_universal_perturbation=args.universal_perturbation,
        )
        patches = tracking.create_subfolder(tracker.folder_path, "patches")
        kw = dict(tracker=tracker, register=not args.unregistered_artifacts)

        flow_fn = None
        total_images = 0

        for epoch in range(epochs):
            print("Evaluation for perturbation from epoch %d" % epoch)
            image_hw = next(iter(loader))[0].shape[1:3]

            d1 = load_delta_nhwc(delta1_paths[epoch])
            d1 = convert_perturbationsizes(d1, image_hw, args.origin_net,
                                           args.net)
            if args.universal_perturbation:
                # universal mode replays δ1 on both frames, as the
                # reference does
                d2 = d1
            else:
                d2 = load_delta_nhwc(delta2_paths[epoch])
                d2 = convert_perturbationsizes(d2, image_hw, args.origin_net,
                                               args.net)
            d1t, d2t = (torch.from_numpy(np.ascontiguousarray(d)).to(dev)
                        for d in (d1, d2))

            images_passed = 0
            sum_aee_adv_pred = 0.0

            for batch, (img1, img2, _flow_gt, _valid) in enumerate(
                    common.progress(loader)):
                x1, x2 = common.unit_images(img1, img2, dev)
                if flow_fn is None:
                    padder, flow_fn = make_flow_fn(
                        loaded, x1.shape[1:3],
                        common.pad_mode_for(args.dataset))
                p1, p2 = padder.pad(x1, x2)
                with torch.no_grad():
                    flow_pred_init = flow_fn(p1, p2)
                    flow_pred = flow_fn(clip01(p1 + d1t[None]),
                                        clip01(p2 + d2t[None]))

                for i in range(p1.shape[0]):
                    curr = total_images + images_passed + i
                    tracker.log_metrics(curr, ("steps", images_passed + i),
                                        ("batch", batch), ("epoch", epoch))
                    aee_adv_pred = common.epe(flow_pred[i:i + 1],
                                              flow_pred_init[i:i + 1])
                    sum_aee_adv_pred += aee_adv_pred
                    tracker.log_metric("aee_pred-predadv", aee_adv_pred, curr)

                    if common.should_save(images_passed + i, args):
                        save_tensor(d1, "delta1", curr, patches, **kw)
                        save_tensor(d2, "delta2", curr, patches, **kw)
                        save_tensor(p1[i:i + 1], "image1", curr, patches, **kw)
                        save_tensor(p2[i:i + 1], "image2", curr, patches, **kw)
                        save_tensor(flow_pred[i:i + 1], "flow_pred", curr,
                                    patches, **kw)
                        save_tensor(flow_pred_init[i:i + 1], "flow_pred_init",
                                    curr, patches, **kw)
                        save_image(p1[i:i + 1], curr, patches,
                                   image_name="image1", **kw)
                        save_image(p2[i:i + 1], curr, patches,
                                   image_name="image2", **kw)
                        save_image(p1[i] + d1t, curr, patches,
                                   image_name="image1_delta", **kw)
                        save_image(p2[i] + d2t, curr, patches,
                                   image_name="image2_delta", **kw)
                        mf = tracking.max_flow_length(
                            flow_pred_init[i:i + 1], flow_pred[i:i + 1])
                        save_flow(flow_pred[i:i + 1], curr, patches,
                                  flow_name="flow_pred",
                                  auto_scale=False, max_scale=mf, **kw)
                        save_flow(flow_pred_init[i:i + 1], curr, patches,
                                  flow_name="flow_pred_init",
                                  auto_scale=False, max_scale=mf, **kw)

                images_passed += p1.shape[0]

            avg_aee_adv_pred = sum_aee_adv_pred / images_passed
            total_images += images_passed

            tracker.log_metric("epoch_aee_pred-predadv", avg_aee_adv_pred,
                               total_images - 1)
            l2_d1 = float(two_norm_avg(d1t))
            l2_d2 = float(two_norm_avg(d2t))
            l2_d12 = float(two_norm_avg_delta(d1t, d2t))
            tracker.log_metrics(total_images - 1, ("l2_delta1", l2_d1),
                                ("l2_delta2", l2_d2),
                                ("l2_delta-avg", l2_d12))

            max_delta = max(float(np.abs(d1).max()), float(np.abs(d2).max()))
            save_image(d1, total_images - 1, patches,
                       image_name=f"delta1_e{epoch}",
                       normalize_max=max_delta or None, **kw)
            if not args.joint_perturbation:
                save_image(d2, total_images - 1, patches,
                           image_name=f"delta2_e{epoch}",
                           normalize_max=max_delta or None, **kw)

            print("Finished attacking epoch %d" % epoch)
            print("\tAEE(f_adv, f_init)=%f" % avg_aee_adv_pred)
            print("\tL2(perturbation)  =%f\n" % l2_d12)
            results[epoch] = {"aee_adv_pred": avg_aee_adv_pred,
                              "l2_delta12": l2_d12}
    return results


def main(argv=None, device: str | torch.device = "cuda"):
    parser = create_parser(stage="evaluation", attack_type="pcfa")
    args = parser.parse_args(argv)
    print(args)
    if args.universal_perturbation:
        return eval_l2_universal(args, device)
    raise ValueError(
        "An additional evaluation for non-universal perturbations is not "
        "implemented."
    )


if __name__ == "__main__":
    main()
