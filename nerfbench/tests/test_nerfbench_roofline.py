"""The roofline and MFU arithmetic against hand-worked shapes."""

import math

import pytest

from nerfbench import roofline, spec
from nerfbench.methods import NeRF


def test_bound_is_the_slower_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 1.0, roofline.SFU_OPS_PER_S) == \
        pytest.approx(1.0)
    assert roofline.SFU_OPS_PER_S == pytest.approx(4.18176e12)


WORK = {'entries': 1000, 'num_tiles': 10, 'live_chunks': 40,
        'passing': 5000, 'stream_entries': 6000, 'gaussians': 2000,
        'pixels': 640}


def test_composite_forward_counts():
    # 1000 entries x 10 f32 + 10 tiles x (start, count) + 10 x 5 x 256 f32
    # out + 40 live chunks x 256 f32 of saved transmittance
    assert roofline.gs_composite_fwd(WORK, packed=False) == \
        (40000 + 80 + 51200 + 40960, 27 * 5000, 5000)
    # packed: 5 words an entry, nothing saved
    assert roofline.gs_composite_fwd(WORK, packed=True) == \
        (20000 + 80 + 51200, 27 * 5000, 5000)


def test_composite_backward_counts():
    # entries, segments, saved transmittance and d out read; d of the 10
    # attribute rows written over the whole stream of 6000 entries
    assert roofline.gs_composite_bwd(WORK) == \
        (40000 + 80 + 40960 + 51200 + 240000, 68 * 5000, 5000)


def test_gs_flops():
    assert roofline.gs_frame_flops(WORK) == 2000 * 420 + 27 * 5000
    assert roofline.gs_step_flops(WORK) == (
        2000 * 1260 + 95 * 5000 + 640 * 3 * 735 + 2000 * 59 * 12)


def test_nerf_step_flops_by_hand():
    cell = spec.Cell('nerf_train')
    # fine block multiply-adds a sample: trunk 256 x (63 + 4 x 256 + 319 +
    # 2 x 256), density 256, feature 256 x 256, colour 283 x 128, rgb
    # 128 x 3
    macs = 256 * (63 + 1024 + 319 + 512) + 256 + 65536 + 283 * 128 + 384
    assert macs == 593408
    flops = NeRF.step_flops(cell.config)
    assert flops == 6 * macs * 4096 * (64 + 256)
    assert flops == pytest.approx(4.667e12, rel=1e-3)


def test_mfu_and_roofline_readers():
    class Trace:
        window_s = 2.0

        def layer_s(self, layer):
            return 0.5 if layer == 'composite' else None

    class Ctx:
        trace = Trace()
        units = [0, 1]
        peak_flops = 67e12

        def work(self):
            step = dict(WORK, flops=roofline.gs_step_flops(WORK))
            return [step, step]
    mfu = spec.metric_module('mfu_pct.train').read(Ctx())
    assert mfu == pytest.approx(100 * 2 * roofline.gs_step_flops(WORK) /
                                2.0 / 67e12)
    share = spec.metric_module('gs_composite_roofline.train').read(Ctx())
    least = 2 * (roofline.bound_s(*roofline.gs_composite_fwd(WORK, False)) +
                 roofline.bound_s(*roofline.gs_composite_bwd(WORK)))
    assert share == pytest.approx(100 * least / 0.5)
    assert math.isfinite(share) and share > 0


def test_gs_work_carries_its_flops():
    """A step's and a served frame's work hold their own FLOPs, which the
    MFU readers sum."""
    from nerfbench.methods import GaussianSplatting
    from tiny import tiny_cell
    serve = tiny_cell('gs360_render_1080p')
    [frame] = GaussianSplatting.render_work(serve.config, serve.traffic, 3,
                                            [0], 'cpu')
    assert frame['flops'] == roofline.gs_frame_flops(frame) > 0
    train = tiny_cell('gs360_train')
    [step] = GaussianSplatting.train_work(train.config, train.traffic, 3,
                                          {'seed': 5}, [0], 'cpu')
    assert step['flops'] == roofline.gs_step_flops(step) > 0
