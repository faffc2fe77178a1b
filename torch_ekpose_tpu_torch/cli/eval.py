"""COCO keypoint evaluation (reference eval.py) on a CUDA card.

    python -m torch_ekpose_tpu_torch.cli.eval -m vgg2016 -c ckpt.pth \\
        -d coco --mode val --data-dir ./data/

Reads ``<data-dir>/<datasets>/images/<mode>/`` and
``<data-dir>/<datasets>/annotations_<mode>.json``. On ``--device cuda``
(the default) an unset ``--batch`` is 8 and ``--decode-backend auto``
decodes on the card (``device``), as the JAX CLI does on its TPU; on
another device the defaults stay the reference's: batch 1, host decode.
``--num-devices N`` shards each batch over N devices
(``parallel/inference.py``, each decoding its shard on the card);
``--batch`` must then be a multiple of N. Reading the images needs cv2
or Pillow.
"""

from __future__ import annotations

import argparse
import os

import torch

from torch_ekpose_tpu_torch.cli import common
from torch_ekpose_tpu_torch.evaluate import run_eval


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    common.add_model_args(parser)
    parser.add_argument("-d", "--datasets", type=str, required=True,
                        help="dataset directory name under --data-dir")
    parser.add_argument("--data-dir", type=str, default="./data/")
    parser.add_argument("--mode", type=str, default="val")
    parser.add_argument("--save", type=int, default=0,
                        help="save every Nth visualization (0 = never)")
    parser.add_argument("--json", action="store_true",
                        help="keep results.json")
    parser.add_argument("--vis-dir", type=str, default="results/")
    parser.add_argument("--n-images", type=int, default=None)
    parser.add_argument("-b", "--batch", type=int, default=None,
                        help="shape-bucketed batch size (>1 batches the "
                        "forward pass per padded-shape bucket). Default: "
                        "8 on a CUDA card, 1 elsewhere (the reference's "
                        "shape)")
    common.add_mesh_arg(parser, "shard each eval batch")
    args = parser.parse_args(argv)

    # card defaults: bucketed batched forward + decode on the card;
    # explicit --batch / --decode-backend flags always win
    on_card = torch.device(args.device).type == "cuda"
    if args.batch is None:
        args.batch = 8 if on_card else 1
    if on_card and args.decode_backend == "auto":
        args.decode_backend = "device"

    if args.num_devices > 1:
        if args.batch % args.num_devices:
            raise SystemExit(
                f"--batch {args.batch} must be a multiple of "
                f"--num-devices {args.num_devices}"
            )
        estimator = common.build_parallel_estimator(args, "sharded")
    else:
        estimator = common.build_estimator(args)
    image_dir = os.path.join(args.data_dir, args.datasets, "images", args.mode)
    anno = os.path.join(
        args.data_dir, args.datasets, f"annotations_{args.mode}.json"
    )
    ap = run_eval(
        image_dir=image_dir,
        anno_file=anno,
        estimator=estimator,
        mode=args.mode,
        vis_dir=args.vis_dir if args.save else None,
        save_every=args.save,
        results_json=(
            os.path.join(args.vis_dir, "results.json") if args.json else None
        ),
        n_images=args.n_images,
        batch_size=args.batch,
    )
    print(f"AP@OKS = {ap:.4f}")


if __name__ == "__main__":
    main()
