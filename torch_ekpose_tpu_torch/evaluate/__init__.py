"""COCO keypoint evaluation (counterpart of the JAX package's
``evaluate/``): the OKS evaluator and the validation loop."""

from torch_ekpose_tpu_torch.evaluate.cocoeval import COCOKeypointEval
from torch_ekpose_tpu_torch.evaluate.evaluator import (
    append_result,
    eval_coco,
    run_eval,
)

__all__ = ["COCOKeypointEval", "append_result", "eval_coco", "run_eval"]
