"""The frozen cost functions against the numbers chip_smoke.py prints."""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
# one thread per test process: the tests run in several workers at once
torch.set_num_threads(1)

from perfbench.costs import bound_ms, kernel_cost, resunet, view_tiles  # noqa: E402


@pytest.mark.parametrize("kernel", ["k2_masked", "k2_unfolded"])
def test_main_tile(kernel):
    flops, nbytes = kernel_cost(kernel)(10, 2048, 256, 35)
    assert flops == 1615848013824          # 1.616e12, chip_smoke's main tile
    assert abs(bound_ms(flops, nbytes) - 1.634) < 5e-4   # compute-bound


@pytest.mark.parametrize("kernel,nbytes", [("k2_masked", 381182084), ("k2_unfolded", 548438016)])
def test_main_tile_bytes(kernel, nbytes):
    assert kernel_cost(kernel)(10, 2048, 256, 35)[1] == nbytes


def test_view_tiles():
    cfg = {"gnt_kernel_cost": "k2_masked", "hw": [288, 550], "ray_tile": 2048,
           "n_spatial": 10, "n_coarse_samples": 256, "gnt_in_channels": 35}
    tiles = view_tiles(cfg)
    assert len(tiles) == 78                  # chip_smoke's launches per 288x550 view
    assert tiles[-1]["flops"] < tiles[0]["flops"]


@pytest.mark.parametrize("hw", [(288, 550), (64, 96), (37, 53)])
def test_resunet_flops_match_the_module(hw):
    """The ResUNet count against the convolutions the program's module runs."""
    from pgdvs_tpu_torch.models.gnt.feature_net import ResUNet

    net = ResUNet().eval()
    total = []

    def hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        total.append(2 * m.in_channels * m.out_channels * k * out.shape[-2] * out.shape[-1])

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.zeros(1, *hw, 3))
    assert resunet.flops(1, *hw) == sum(total)
