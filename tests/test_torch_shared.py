"""The port's own copies of the JAX package's host-side modules
(``constants``, ``config``, ``utils/human``, ``decode/oracle``,
``data/coco``, ``evaluate/cocoeval``, the training input pipeline and
loop helpers: ``data/{preprocessing,transforms,dataset,raw_cache}``,
``training/{schedule,metrics}``, ``cli/test_loader``, the legacy
decoder ``decode/legacy`` and the synthetic scenes ``decode/synthetic``)
against their originals.

The port imports nothing of the JAX package, so it keeps copies; these
tests hold each copy equal to its original: the code itself (the syntax
tree, with the module docstring set aside and the package name mapped),
every public constant by value, ``Config()``'s default fields, and what
``Human`` computes on the same person.
"""

import ast
import dataclasses
import enum
import inspect
import types

import numpy as np
import pytest

from torch_ekpose_tpu import config as jax_config
from torch_ekpose_tpu import constants as jax_constants
from torch_ekpose_tpu.cli import test_loader as jax_test_loader
from torch_ekpose_tpu.data import coco as jax_coco
from torch_ekpose_tpu.data import dataset as jax_dataset
from torch_ekpose_tpu.data import preprocessing as jax_preprocessing
from torch_ekpose_tpu.data import raw_cache as jax_raw_cache
from torch_ekpose_tpu.data import transforms as jax_transforms
from torch_ekpose_tpu.decode import legacy as jax_legacy
from torch_ekpose_tpu.decode import oracle as jax_oracle
from torch_ekpose_tpu.decode import synthetic as jax_synthetic
from torch_ekpose_tpu.evaluate import cocoeval as jax_cocoeval
from torch_ekpose_tpu.ops import resize as jax_resize
from torch_ekpose_tpu.training import metrics as jax_metrics
from torch_ekpose_tpu.training import schedule as jax_schedule
from torch_ekpose_tpu.utils import human as jax_human
from torch_ekpose_tpu_torch import config as port_config
from torch_ekpose_tpu_torch import constants as port_constants
from torch_ekpose_tpu_torch.cli import test_loader as port_test_loader
from torch_ekpose_tpu_torch.data import coco as port_coco
from torch_ekpose_tpu_torch.data import dataset as port_dataset
from torch_ekpose_tpu_torch.data import preprocessing as port_preprocessing
from torch_ekpose_tpu_torch.data import raw_cache as port_raw_cache
from torch_ekpose_tpu_torch.data import transforms as port_transforms
from torch_ekpose_tpu_torch.decode import legacy as port_legacy
from torch_ekpose_tpu_torch.decode import oracle as port_oracle
from torch_ekpose_tpu_torch.decode import synthetic as port_synthetic
from torch_ekpose_tpu_torch.evaluate import cocoeval as port_cocoeval
from torch_ekpose_tpu_torch.ops import resize as port_resize
from torch_ekpose_tpu_torch.training import metrics as port_metrics
from torch_ekpose_tpu_torch.training import schedule as port_schedule
from torch_ekpose_tpu_torch.utils import human as port_human

PAIRS = [(jax_constants, port_constants), (jax_config, port_config),
         (jax_human, port_human), (jax_oracle, port_oracle),
         (jax_coco, port_coco), (jax_cocoeval, port_cocoeval),
         (jax_preprocessing, port_preprocessing),
         (jax_transforms, port_transforms), (jax_dataset, port_dataset),
         (jax_schedule, port_schedule), (jax_metrics, port_metrics),
         (jax_test_loader, port_test_loader),
         (jax_raw_cache, port_raw_cache), (jax_legacy, port_legacy),
         (jax_synthetic, port_synthetic)]


def _body(module, rename=False) -> str:
    source = inspect.getsource(module)
    if rename:
        source = source.replace("torch_ekpose_tpu_torch", "torch_ekpose_tpu")
    tree = ast.parse(source)
    body = tree.body[1:] if ast.get_docstring(tree) is not None else tree.body
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("orig,copy", PAIRS,
                         ids=["constants", "config", "human", "oracle",
                              "coco", "cocoeval", "preprocessing",
                              "transforms", "dataset", "schedule", "metrics",
                              "test_loader", "raw_cache", "legacy",
                              "synthetic"])
def test_copy_has_the_originals_code(orig, copy):
    assert _body(copy, rename=True) == _body(orig)


def _public(module):
    return {n: v for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and n != "annotations"}


def test_every_public_constant_is_equal():
    orig, copy = _public(jax_constants), _public(port_constants)
    assert sorted(orig) == sorted(copy)
    for name, want in orig.items():
        got = copy[name]
        if isinstance(want, type) and issubclass(want, enum.Enum):
            assert [(m.name, m.value) for m in got] == [
                (m.name, m.value) for m in want], name
        elif callable(want):
            continue                       # checked on data below
        else:
            assert type(got) is type(want) and got == want, name
    kps = np.random.default_rng(0).random((3, 17, 3)).astype(np.float32)
    internal = jax_constants.coco_to_internal_keypoints(kps)
    np.testing.assert_array_equal(
        port_constants.coco_to_internal_keypoints(kps), internal)
    np.testing.assert_array_equal(
        port_constants.internal_to_coco_keypoints(internal),
        jax_constants.internal_to_coco_keypoints(internal))


def test_config_defaults_are_equal():
    assert dataclasses.asdict(port_config.Config()) == dataclasses.asdict(
        jax_config.Config())
    assert port_config.cfg.to_dict() == jax_config.cfg.to_dict()
    assert port_config.Config.from_dict({"DECODE": {"max_people": 4}}) \
        .DECODE.max_people == 4


def _person(module):
    h = module.Human()
    rng = np.random.default_rng(1)
    for part in range(18):
        x, y, s = rng.random(3)
        h.body_parts[part] = module.BodyPart(f"{part}-0", part, float(x),
                                             float(y), float(s))
    h.score = 3.5
    return h


def test_human_computes_the_same():
    want, got = _person(jax_human), _person(port_human)
    assert str(got) == str(want)
    for mode in (0, 1):
        assert got.get_face_box(432, 368, mode) == want.get_face_box(
            432, 368, mode)
    assert got.get_upper_body_box(432, 368) == want.get_upper_body_box(
        432, 368)
    img = np.zeros((96, 128, 3), np.uint8)
    np.testing.assert_array_equal(
        port_human.draw_humans(img, [got], imgcopy=True),
        jax_human.draw_humans(img, [want], imgcopy=True))


@pytest.mark.parametrize("shape,dst,interp", [
    ((5, 5), (40, 40), "cubic"), ((3, 5), (24, 40), "cubic"),
    ((37, 50, 3), (64, 86), "linear"), ((9, 7, 2), (4, 3), "nearest")])
def test_resize_image_np_is_the_originals(shape, dst, interp):
    """The oracle's patch refinement (x8 bicubic of 5x5 patches, clipped
    ones at the border) and the no-cv2 padding path resize alike."""
    img = np.random.default_rng(2).random(shape).astype(np.float32)
    np.testing.assert_array_equal(
        port_resize.resize_image_np(img, *dst, interp),
        jax_resize.resize_image_np(img, *dst, interp))


def test_legacy_decoder_gives_the_originals_people():
    """``decode/legacy.py``'s copy on the golden decode scenes
    (``tests/data/torch_decode_golden.npz``) returns the JAX package's
    joint list and person rows, and finds people."""
    import os

    golden = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "torch_decode_golden.npz"))
    found = 0
    for heat, paf in zip(golden["heatmaps"], golden["pafs"]):
        joints, people = port_legacy.paf_to_pose_legacy(heat, paf)
        want_joints, want_people = jax_legacy.paf_to_pose_legacy(heat, paf)
        np.testing.assert_array_equal(joints, want_joints)
        np.testing.assert_array_equal(people, want_people)
        found += len(people)
    assert found > 0
