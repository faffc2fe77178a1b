"""Single-image / directory pose inference (reference run_image.py).

    python -m torch_ekpose_tpu_torch.cli.run_image -m vgg2016 -c ckpt.pth \\
        -i input.png -o out.png
    python -m torch_ekpose_tpu_torch.cli.run_image --input-dir demo/ \\
        --output-dir demo/outputs/

``--analyze`` renders heatmap / PAF-x / PAF-y overlays in a 2x2 grid
instead of the skeleton image (reference run_image.py:33-40,64-109 —
same either/or behavior); it needs matplotlib. ``--num-devices N``
splits each image's height over N devices (``parallel/spatial.py``;
single-device only with ``--analyze``). Images are read and written
through cv2, else Pillow.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from torch_ekpose_tpu_torch.cli import common
from torch_ekpose_tpu_torch.evaluate.evaluator import (
    _write_image,
    read_image_bgr,
)
from torch_ekpose_tpu_torch.utils.human import draw_humans


def process_image(estimator, input_path: str, output_path: str) -> int:
    image = read_image_bgr(input_path)
    humans, _ = estimator.estimate(image)
    out = draw_humans(image, humans)
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    _write_image(output_path, out)
    return len(humans)


def process_image_analyze(estimator, input_path: str, output_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    image = read_image_bgr(input_path)
    pafs, heatmaps, _ = estimator.get_outputs(image)
    from torch_ekpose_tpu_torch.decode.api import paf_to_pose

    humans = paf_to_pose(heatmaps, pafs, estimator.config)
    drawn = draw_humans(image.copy(), humans)

    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    axes[0, 0].imshow(drawn[:, :, ::-1])
    axes[0, 0].set_title("result")
    axes[0, 1].imshow(heatmaps[:, :, :18].max(axis=2), cmap="hot")
    axes[0, 1].set_title("heatmaps (max over parts)")
    axes[1, 0].imshow(np.abs(pafs[:, :, 0::2]).max(axis=2), cmap="hot")
    axes[1, 0].set_title("|PAF x| (max)")
    axes[1, 1].imshow(np.abs(pafs[:, :, 1::2]).max(axis=2), cmap="hot")
    axes[1, 1].set_title("|PAF y| (max)")
    for ax in axes.flat:
        ax.axis("off")
    base, ext = os.path.splitext(output_path)
    fig.savefig(f"{base}_analyze{ext or '.png'}", bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    common.add_model_args(parser)
    parser.add_argument("-i", "--image", type=str, default=None)
    parser.add_argument("-o", "--output", type=str, default=None)
    parser.add_argument("--input-dir", type=str, default="./demo/")
    parser.add_argument("--output-dir", type=str, default="./demo/outputs/")
    parser.add_argument("-a", "--analyze", action="store_true")
    common.add_mesh_arg(parser, "split each image's height")
    args = parser.parse_args(argv)
    if args.analyze:
        if args.num_devices > 1:
            raise SystemExit("--analyze is single-device only")
        common.require("matplotlib", "--analyze")

    estimator = (common.build_parallel_estimator(args, "spatial")
                 if args.num_devices > 1 else common.build_estimator(args))

    if args.image:
        output = args.output or os.path.join(
            args.output_dir, os.path.basename(args.image)
        )
        if args.analyze:
            process_image_analyze(estimator, args.image, output)
        else:
            n = process_image(estimator, args.image, output)
            print(f"INFO: {n} people -> {output}")
        return

    names = [
        f for f in sorted(os.listdir(args.input_dir))
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    ]
    for name in names:
        n = process_image(
            estimator,
            os.path.join(args.input_dir, name),
            os.path.join(args.output_dir, name),
        )
        print(f"INFO: {name}: {n} people")


if __name__ == "__main__":
    main()
