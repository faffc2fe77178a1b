"""Data-loader smoke test (reference test_loader.py, repaired): visualize
one training batch — image, GT heatmaps, and PAFs.

    python -m torch_ekpose_tpu_torch.cli.test_loader -d coco --data-dir ./data/

The reference version is stale (passes ``mask_dir`` and unpacks four
values against a three-value dataset, test_loader.py:13,52); this one
matches the live dataset contract. Needs matplotlib.

The port's own copy of the JAX package's ``cli/test_loader.py``, code for
code (``tests/test_torch_shared.py`` holds the syntax trees equal).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.data import transforms as T
from torch_ekpose_tpu_torch.data.dataset import CocoKeypoints


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--datasets", type=str, required=True)
    parser.add_argument("--data-dir", type=str, default="./data/")
    parser.add_argument("--mode", type=str, default="train")
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--square_size", type=int, default=368)
    parser.add_argument("-o", "--output", type=str, default="loader_vis.png")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ds = CocoKeypoints(
        os.path.join(args.data_dir, args.datasets, "images", args.mode),
        os.path.join(
            args.data_dir, args.datasets, f"annotations_{args.mode}.json"
        ),
        preprocess=T.TRAIN_PREPROCESS(args.square_size),
        image_transform=T.image_transform_train,
        target_mode="host",
        input_size=args.square_size,
    )
    image, heatmaps, pafs = ds[args.index]

    mean = np.asarray(constants.IMAGENET_MEAN)
    std = np.asarray(constants.IMAGENET_STD)
    rgb = np.clip(image * std + mean, 0, 1)

    fig, axes = plt.subplots(2, 2, figsize=(11, 10))
    axes[0, 0].imshow(rgb)
    axes[0, 0].set_title("augmented image")
    axes[0, 1].imshow(heatmaps[:, :, :18].max(axis=2), cmap="hot")
    axes[0, 1].set_title("heatmaps (max)")
    axes[1, 0].imshow(heatmaps[:, :, -1], cmap="gray")
    axes[1, 0].set_title("background channel")
    axes[1, 1].imshow(np.abs(pafs).max(axis=2), cmap="hot")
    axes[1, 1].set_title("|PAF| (max)")
    for ax in axes.flat:
        ax.axis("off")
    fig.savefig(args.output, bbox_inches="tight")
    print(f"INFO: dataset has {len(ds)} images; wrote {args.output}")


if __name__ == "__main__":
    main()
