"""Raw-output visualizer (reference vis_output.py): plot every heatmap and
PAF channel for one image. Needs matplotlib.

    python -m torch_ekpose_tpu_torch.cli.vis_output -m vgg2016 -c ckpt.pth \\
        -i image.png -o channels.png
"""

from __future__ import annotations

import argparse

from torch_ekpose_tpu_torch.cli import common
from torch_ekpose_tpu_torch.evaluate.evaluator import read_image_bgr


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    common.add_model_args(parser)
    parser.add_argument("-i", "--image", type=str, required=True)
    parser.add_argument("-o", "--output", type=str, default="vis_output.png")
    args = parser.parse_args(argv)

    matplotlib = common.require("matplotlib", "vis_output")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    estimator = common.build_estimator(args)
    pafs, heatmaps, _ = estimator.get_outputs(read_image_bgr(args.image))

    n_heat, n_paf = heatmaps.shape[-1], pafs.shape[-1]
    cols = 8
    rows = -(-(n_heat + n_paf) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.0 * rows))
    axes = axes.reshape(-1)
    for i in range(n_heat):
        axes[i].imshow(heatmaps[:, :, i], cmap="hot")
        axes[i].set_title(f"ht {i}", fontsize=7)
    for i in range(n_paf):
        axes[n_heat + i].imshow(pafs[:, :, i], cmap="coolwarm")
        axes[n_heat + i].set_title(f"paf {i}", fontsize=7)
    for ax in axes:
        ax.axis("off")
    fig.savefig(args.output, bbox_inches="tight", dpi=110)
    print(f"INFO: wrote {args.output}")


if __name__ == "__main__":
    main()
