"""Plain float32 references of the benchmark's model families and decode.

Each family (``vgg``, ``mobilenet``) is one module with the same four
functions, found by the name a configuration file gives under
``"reference"``:

- ``param_specs(cfg)``: ``[(state_dict name, shape, kind)]`` of every
  tensor, in the reference repository's ``state_dict`` names, where
  ``kind`` says how the benchmark initialises it;
- ``forward(params, x, cfg, int8=False)``: NCHW float32 input ->
  ``{"paf", "heat", "paf_pre", "heat_pre"}`` float32 NCHW, a ``_pre``
  being the tensor that the head's shaping normalises;
- ``shape_head(params, stats, cfg, targets, slopes)``: the final
  projections rewritten so that channel ``c`` of branch ``k`` ("heat",
  "paf") becomes ``slopes[k] * z + targets[k][c]`` (``z``: its standard
  score under ``stats[k] = (mean, std)``);
- ``head_projections(cfg)``: the ``state_dict`` prefixes of the two
  projections ``shape_head`` rewrites.

``decode.py`` is the decode, written from the port's documented decode
semantics. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import importlib

__all__ = ["family"]


def family(name: str):
    """The reference module of family ``name`` (``portbench/reference/
    <name>.py``)."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad reference family name {name!r}")
    return importlib.import_module(f"portbench.reference.{name}")
