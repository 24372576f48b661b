"""The benchmark's counters against hand counts at one small shape: the
kernels' least times and the models' operations."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from etbench import roofline
from etbench.reference import agentformer, etspace, stgcnn
from etbench.reference.checkpoint import read_checkpoint
from etbench.reference.pipeline import checkpoint_path
from etbench.run import load_json


def test_reconstruct_bound_by_hand():
    # n = 2 pedestrians, one moving: both bases. Bytes in: coefficients
    # 6*20*4*2 = 960, bases 2*12*6*4*2 = 1,152, ori/rot/sca/mask 2*29 = 58;
    # out: 20*2*12*2*4 = 3,840. Operations: 2*20*12*(24 + 8) = 15,360.
    assert roofline.recon_bytes_in(2, 1, 6, 20, 12) == 2170
    want = max((2170 + 3840) / 3.35e12, 15360 / 67e12) * 1e3
    assert roofline.reconstruct_bound_ms(2, 1) == pytest.approx(want, rel=1e-12)
    # all static: one basis
    assert roofline.recon_bytes_in(2, 0, 6, 20, 12) == 2170 - 576


def test_recon_metrics_bound_by_hand():
    # also gt in (2*12*2*4 = 192) and ade/fde/tcc out (3*2*4 = 24);
    # operations 2*20*12*(24 + 8 + 5) + 2*12*8 = 17,952.
    want = max((2170 + 192 + 3840 + 24) / 3.35e12, 17952 / 67e12) * 1e3
    assert roofline.recon_metrics_bound_ms(2, 1) == pytest.approx(want, rel=1e-12)


def test_bound_takes_the_larger_side():
    assert roofline.bound_ms(3.35e9, 0, 1) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 0, 67e9) == pytest.approx(1.0)


def test_et_flops_by_hand():
    # 3 pedestrians: projection 16 x 6, reconstruction 20 samples of 24 x 6,
    # 2 operations a multiply-add.
    assert etspace.et_flops(3) == 2 * 3 * (16 * 6 + 20 * 24 * 6)


def test_agentformer_flops_by_hand():
    # one agent: 8 encoder and 6 decoder tokens, width 256, feed-forward 512.
    e, f, le, ld = 256, 512, 8, 6
    embed = (le + ld) * (e + 2 * e * e)
    enc = le * (6 * e * e + 2 * e * f) + 3 * le * le * e
    dec = (ld * (6 * e * e) + 3 * ld * ld * e + ld * 3 * e * e + le * 3 * e * e
           + 3 * ld * le * e + ld * 2 * e * f)
    assert agentformer.flops(1) == 2 * (embed + 2 * enc + 2 * dec + ld * e * 20)


def test_stgcnn_flops_by_hand():
    # 2 pedestrians: gcn 8*2*160*2, graph 8*20*8*2*2*2, res 8*2*20*2,
    # tcn 8*2*20*20*3*2, txp over (20, 2): tpcnn_0 8 -> 6, three 6 -> 6 and
    # the output 6 -> 6, 3x3 each: 20*2*(6*8 + 3*36 + 36)*9*2.
    want = (8 * 2 * 160 * 2 + 8 * 20 * 8 * 2 * 2 * 2 + 8 * 2 * 20 * 2 + 8 * 2 * 400 * 3 * 2
            + 20 * 2 * (48 + 108 + 36) * 9 * 2)
    assert stgcnn.flops(2) == want


@pytest.mark.parametrize("name,module,n", [
    ("et-agentformer-zara2", agentformer, 3), ("et-stgcnn-hotel", stgcnn, 3)])
def test_flops_match_the_operations_the_reference_runs(name, module, n):
    config = load_json("etbench", "configs", f"{name}.json")
    model = module.Model(read_checkpoint(checkpoint_path(config, ROOT)), torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    c_obs, ori = torch.randn(1, 6, n, generator=g), torch.randn(1, 2, n, generator=g)
    with FlopCounterMode(display=False) as counter:
        model(c_obs, ori)
    assert counter.get_total_flops() == module.flops(n)
