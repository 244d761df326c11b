"""Command line of the PyTorch port, with ``main.py``'s flags::

    python -m mpp_cnn_rs_object_detection_torch -m {posnet,shapenet,mpp} \
        -p {infer,eval,infereval} -c CONFIG [-d DATASET] [-o] [-r] [-s SUBSET]
    python -m mpp_cnn_rs_object_detection_torch -m {posnet,shapenet,mpp} \
        -p train -c CONFIG [-d DATASET] [-o] [-r]
    python -m mpp_cnn_rs_object_detection_torch -p make_synth [-c CONFIG]
    python -m mpp_cnn_rs_object_detection_torch \
        -p {translate_dota,translate_cowc} -c CONFIG
    python -m mpp_cnn_rs_object_detection_torch -p check_div
    python -m mpp_cnn_rs_object_detection_torch -m oracle \
        -p {infer,eval,infereval} -c config_oracle [-d DATASET]
    python -m mpp_cnn_rs_object_detection_torch -m {fasterrcnn,bbavec} \
        -p {train,infer,eval,infereval} -c CONFIG [-d DATASET] [-o] [-r]
    python -m mpp_cnn_rs_object_detection_torch \
        -m {posnet,shapenet,mpp,oracle,fasterrcnn,bbavec} -p data_preview \
        -c CONFIG [-d DATASET]

It runs on the CUDA device; ``main(argv, device="cpu")`` runs it on the
CPU. ``-p train -m posnet|shapenet`` trains every CNN config: on the
device-resident patch pipeline with ``data_loader.device_pipeline``, else
on the host pipeline (PNG patch sets, host augmentation and targets, hard
mining for a PosNet with ``error_update_interval``). The baseline
detectors (Faster R-CNN, HBB; BBAVectors' CTRBOX, OBB) train on the device
pipeline and infer with their DOTA export. The translators and the oracle
run on the host; ``check_div`` holds the detection-map kernel to its plain
version on the card (on the CPU, the plain version to numpy). Every
``eval`` writes the PR curves beside its metrics. ``data_preview`` writes
the MPP's first 8 train scenes, or a host-pipeline CNN config's first
train batch (its patches, and a PosNet's masks), as PNGs; it refuses a
device-pipeline CNN config (no batch loader) and does nothing for the
oracle and the detectors, as ``main.py``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="MPP+CNN detector, PyTorch port")
    parser.add_argument("-m", "--model", type=str, required=False,
                        choices=["posnet", "shapenet", "mpp", "oracle",
                                 "fasterrcnn", "bbavec"])
    parser.add_argument("-p", "--procedure", type=str, required=True,
                        choices=["train", "infer", "eval", "infereval",
                                 "data_preview", "translate_dota",
                                 "translate_cowc", "make_synth", "check_div"])
    parser.add_argument("-c", "--config", type=str, required=False,
                        help="config file path, config name, or saved "
                             "model name")
    parser.add_argument("-d", "--dataset", type=str, default=None,
                        help="override the config's dataset")
    parser.add_argument("-o", "--overwrite", action="store_true")
    parser.add_argument("-r", "--resume", action="store_true",
                        help="load the saved model and resume")
    parser.add_argument("-s", "--subset", type=str, default="val")
    return parser.parse_args(argv)


def load_config(args) -> dict:
    from mpp_cnn_rs_object_detection_torch.utils.config import (
        resolve_model_config_path,
    )

    with open(resolve_model_config_path(args.config)) as f:
        return json.load(f)


def main(argv=None, device=None):
    """Run one procedure; returns the model it built (for
    ``translate_*`` the images written per subset, for ``check_div`` its
    errors, None for ``make_synth``). ``device`` defaults to the CUDA
    device."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.procedure == "translate_dota":
        from mpp_cnn_rs_object_detection_torch.data.translate_dota import (
            translate_dota,
        )

        return translate_dota(load_config(args))
    if args.procedure == "translate_cowc":
        from mpp_cnn_rs_object_detection_torch.data.translate_cowc import (
            translate_cowc,
        )

        return translate_cowc(load_config(args))
    if args.procedure == "check_div":
        from mpp_cnn_rs_object_detection_torch.ops.check_div import check_div

        return check_div(device)
    if args.procedure == "make_synth":
        from mpp_cnn_rs_object_detection_torch.data.synth import (
            make_synth_dataset,
        )

        make_synth_dataset(**(load_config(args) if args.config else {}))
        return None

    assert args.model is not None, "-m/--model required for this procedure"
    train = args.procedure == "train"
    preview = args.procedure == "data_preview"
    config = load_config(args)
    # as main.py: a training run loads its stored model only to resume
    load = args.resume or not train
    if args.model == "oracle":
        from mpp_cnn_rs_object_detection_torch.models.oracle_model import (
            OracleModel,
        )

        model = OracleModel(config, dataset=args.dataset)
    elif args.model in ("posnet", "shapenet"):
        from mpp_cnn_rs_object_detection_torch.models.base import (
            check_preview_pipeline,
        )
        from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
            PosNetModel,
        )
        from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
            ShapeNetModel,
        )

        if preview:
            # before the trainer builds its data
            check_preview_pipeline(config)
        cls = PosNetModel if args.model == "posnet" else ShapeNetModel
        model = cls(config, device, load=load, dataset=args.dataset,
                    overwrite=args.overwrite, train=train or preview)
    elif args.model in ("fasterrcnn", "bbavec"):
        from mpp_cnn_rs_object_detection_torch.models.fasterrcnn_model import (
            BBAVecModel,
            FasterRCNNModel,
        )

        cls = FasterRCNNModel if args.model == "fasterrcnn" else BBAVecModel
        model = cls(config, device, overwrite=args.overwrite, load=load,
                    train=train, dataset=args.dataset)
    else:
        from mpp_cnn_rs_object_detection_torch.mpp.mpp_model import MPPModel

        model = MPPModel(config, phase="train" if train else "infer",
                         overwrite=args.overwrite,
                         load=load, dataset=args.dataset,
                         device=device)

    if train:
        model.train()
    elif preview:
        model.data_preview()
    elif args.procedure == "infer":
        model.infer(subset=args.subset, overwrite=args.overwrite)
    elif args.procedure == "eval":
        model.eval()
    else:
        model.infer(subset=args.subset, overwrite=args.overwrite)
        model.eval()
    return model


if __name__ == "__main__":
    main(sys.argv[1:])
