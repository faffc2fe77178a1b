"""The port's serving CLI resolves ``--dtype`` against ``--precision`` as
the JAX package's CLI does (``torch_ekpose_tpu/cli/common.py::
_resolve_dtype``): unset under ``highest`` is float32, otherwise bfloat16;
an explicit ``--dtype`` wins; ``highest`` with an int8 mode exits with the
same message. Each case parses one argument list with both packages'
parsers and resolves it with each package's own function.
"""

import argparse

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_ekpose_tpu.cli import common  # noqa: E402
from torch_ekpose_tpu_torch.cli import serve  # noqa: E402

ARGVS = {
    "unset": [],
    "fast_unset": ["--precision", "fast"],
    "highest_unset": ["--precision", "highest"],
    "highest_bf16": ["--precision", "highest", "--dtype", "bfloat16"],
    "fast_f32": ["--dtype", "float32"],
    "highest_int8": ["--precision", "highest", "--dtype", "int8"],
    "highest_int8_static": ["--precision", "highest", "--dtype",
                            "int8_static"],
    "fast_int8": ["--dtype", "int8"],
}
WANT = {"unset": "bfloat16", "fast_unset": "bfloat16",
        "highest_unset": "float32", "highest_bf16": "bfloat16",
        "fast_f32": "float32", "highest_int8": SystemExit,
        "highest_int8_static": SystemExit, "fast_int8": "int8"}


def _jax_resolved(argv):
    parser = argparse.ArgumentParser()
    common.add_model_args(parser)
    args = parser.parse_args(argv)
    common._resolve_dtype(args)
    return args.dtype


@pytest.mark.parametrize("case", list(ARGVS))
def test_serve_resolves_dtype_as_the_jax_cli(case):
    argv = ARGVS[case]
    if WANT[case] is SystemExit:
        with pytest.raises(SystemExit) as ref:
            _jax_resolved(argv)
        with pytest.raises(SystemExit) as got:
            serve.parse_args(argv)
        assert str(got.value) == str(ref.value)
        assert "--precision highest" in str(got.value)
        return
    args = serve.parse_args(argv)
    assert args.dtype == _jax_resolved(argv) == WANT[case]
    assert serve.build_parser().parse_args(argv).dtype == (
        None if "--dtype" not in argv else WANT[case])
    serve.resolve_dtype(args)              # idempotent
    assert args.dtype == WANT[case]
    assert serve._DTYPES[args.dtype] in (torch.bfloat16, torch.float32,
                                         "int8")


def test_serve_decodes_on_the_device(monkeypatch):
    """The server batches frames: its estimator takes the device decode,
    as the JAX CLI's ``set_defaults(decode_backend="jax")`` gives it."""
    made = {}

    class Stop(Exception):
        pass

    def estimator(*args, **kwargs):
        made.update(kwargs)
        raise Stop

    monkeypatch.setattr(serve, "PoseEstimator", estimator)
    with pytest.raises(Stop):
        serve.main(["--device", "cpu"])
    assert made["decode_backend"] == "device"
    assert made["device"] == "cpu" and made["compute_dtype"] is torch.bfloat16
