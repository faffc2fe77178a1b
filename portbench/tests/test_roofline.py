"""The yardstick's arithmetic: FLOPs as the port's ``cli/summary.py``
counts them, the decode kernels' bytes as PERF.md counts them, and the
conv bound between its two limits."""

from __future__ import annotations

import pytest

from portbench import catalog, roofline
from portbench.reference import family

H100 = roofline.peak_of("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("name, gflop", [("vgg2016", 319), ("mobilenet_thin", 9.93)])
def test_flops_equal_the_port_summary(name, gflop):
    from torch_ekpose_tpu_torch.cli.summary import summarize

    cfg = catalog.load_config(name)
    ours = roofline.forward_flops(family(cfg["reference"]), cfg, 368, 432)
    assert ours == summarize(name, (368, 432))["flops"]
    assert round(ours / 1e9, 2 if gflop < 100 else 0) == gflop


def test_decode_bytes_at_the_serving_shape():
    got = roofline.decode_bytes(8, 46, 54)
    assert got["nms"] == 2_861_568                      # 2.86 MB
    assert round(got["match"] / H100[1] * 1e3, 5) == 0.00020   # ms
    assert round(got["merge"] / 1e6, 2) == 0.20         # MB
    assert roofline.decode_bound_s(8, 46, 54, H100[1]) == pytest.approx(
        sum(got.values()) / 3.35e12)


def test_peaks_table():
    assert H100 == (989e12, 3.35e12)
    assert roofline.peak_of("NVIDIA H100 PCIe")[0] == 756e12
    assert roofline.peak_of("cpu") is None


@pytest.mark.parametrize("name", ["vgg2016", "mobilenet_thin"])
def test_conv_bound_between_its_limits(name):
    cfg = catalog.load_config(name)
    fam = family(cfg["reference"])
    bound = roofline.conv_bound_s(fam, cfg, 368, 432, *H100)
    flops = roofline.forward_flops(fam, cfg, 368, 432)
    assert bound >= flops / H100[0]
    assert bound <= flops / H100[0] + 1.0 / H100[1] * 2 * 4e8
