"""Write the JAX package's data-parallel train step that
``tests/test_torch_parallel_train.py`` holds the port's two-rank step
against: ``tests/data/torch_parallel_golden.npz``.

vgg2016 on the port's seeded reference init (``init_model`` with
``torch.Generator().manual_seed(0)``, carried across by the JAX
package's ``convert_torch_checkpoint``), float32, ``optax.sgd(1e-4)``,
device targets, one step on a 2-device CPU mesh (``parallel.make_mesh(2)``,
the batch sharded by ``shard_batch``) of the global batch
``torch_port_inputs.sparse_batch(4, 32)``. Keys: ``Loss`` and the 16
logged series of that step (the global batch's); the step's parameter
change ``after - before`` in the port's parameter names, at up to
``SAMPLES`` seeded flat indices of each parameter (``delta_keys``, the
parameters' names; ``delta_count``, how many indices each has;
``delta_index`` and ``delta_value``, concatenated in that order) and
the largest |change| of each (``delta_max``).

``spatial_frame``, ``spatial_paf`` and ``spatial_heatmap``: the JAX
package's ``SpatialPoseEstimator`` on a 4-device CPU mesh
(``dest_size=128``, float32), its stage-6 maps (HWC) of one seeded
128x64 frame, for vgg2016 on ``tests/torch_jax_models.py``'s seeded
variables (``jax_variables``). About 20 s of CPU.

    JAX_PLATFORMS=cpu python scripts/make_torch_parallel_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_parallel_golden.npz")
NAME, SIZE, BATCH, LR = "vgg2016", 32, 4, 1e-4
SAMPLES = 64


def main() -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import optax

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    import torch_jax_models as tjm
    import torch_port_inputs as inputs
    import jax.numpy as jnp

    from torch_ekpose_tpu.parallel import (
        SpatialPoseEstimator, make_mesh, replicated, shard_batch)
    from torch_ekpose_tpu.runtime.checkpoint import convert_torch_checkpoint
    from torch_ekpose_tpu.training import (
        create_train_state, make_train_step)
    from torch_ekpose_tpu_torch.models.factory import init_model
    from torch_ekpose_tpu_torch.runtime.checkpoint import state_dict_from_jax

    model = tjm.jax_model(NAME)
    state_dict = init_model(NAME, generator=torch.Generator().manual_seed(0),
                            device="cpu").state_dict()
    variables = convert_torch_checkpoint(
        {k: v.numpy() for k, v in state_dict.items()}, NAME)
    images, kpts = inputs.sparse_batch(BATCH, SIZE)
    mesh = make_mesh(2)
    state = jax.device_put(
        create_train_state(model, variables, optax.sgd(np.float32(LR))),
        replicated(mesh))
    step = make_train_step(model, targets="device",
                           grid=(SIZE // 8, SIZE // 8))
    state, logs = step(state, *shard_batch(mesh, (images, kpts)))
    out = {k: np.float32(v) for k, v in jax.device_get(logs).items()}
    after = state_dict_from_jax(
        {"params": jax.device_get(state.params)}, NAME)
    rng = np.random.default_rng(0)
    keys, counts, index, value, largest = [], [], [], [], []
    for key in sorted(after):
        delta = (after[key].double() - state_dict[key].double()).numpy()
        delta = delta.ravel()
        pick = np.sort(rng.choice(delta.size, min(delta.size, SAMPLES),
                                  replace=False))
        keys.append(key)
        counts.append(pick.size)
        index.append(pick)
        value.append(delta[pick])
        largest.append(np.abs(delta).max())
    out.update(delta_keys=np.array(keys), delta_count=np.array(counts),
               delta_index=np.concatenate(index).astype(np.int32),
               delta_value=np.concatenate(value),
               delta_max=np.array(largest))

    frame = np.random.default_rng(1).integers(0, 256, (128, 64, 3),
                                              dtype=np.uint8)
    sp = SpatialPoseEstimator(model, tjm.jax_variables(NAME),
                              mesh=make_mesh(4), dest_size=128)
    im_pad, _ = sp.pad(frame)
    x = jax.device_put(jnp.asarray(im_pad)[None], sp._spatial)
    paf, heatmap = sp._forward_fn(*im_pad.shape[:2])(sp.variables, x)
    out.update(spatial_frame=frame, spatial_paf=np.asarray(paf),
               spatial_heatmap=np.asarray(heatmap))
    np.savez(GOLDEN, **out)
    print(f"wrote {os.path.relpath(GOLDEN, ROOT)}: Loss {out['Loss']}")


if __name__ == "__main__":
    main()
