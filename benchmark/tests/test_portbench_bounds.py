"""The frozen operation and byte counts against hand-worked values, the
roofline reader's arithmetic, and the configuration files' operation
counts against the reference counted on the meta device."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark.harness import core, readers
from benchmark.reference import bounds
from benchmark.reference.models import count_operations


def test_flash_mha_k1():
    q = (2, 8, 2688, 64)
    # 4 * 2*8 * 2688^2 * 64; q, k, v read and o written: 4 B * 2*8 * (2*2688 + 2*2688) * 64
    assert bounds.flash_mha(q, q, q) == (29_595_009_024, 44_040_192)
    t, by = bounds.least_seconds(*bounds.flash_mha(q, q, q))
    assert by == "operations" and t == pytest.approx(29_595_009_024 / 495e12)


def test_flash_mha_bwd_k3():
    q = (4, 8, 2688, 64)
    # 10 * 32 * 2688^2 * 64; 4 B * 32 * 64 * (4*2688 + 4*2688) + 4 B * 32 * 2688 (lse)
    assert bounds.flash_mha_bwd(q, q, q, q, (4, 8, 2688), q) == (147_975_045_120, 176_504_832)


def test_dconv_sub_block_k5():
    # N=1024 rows of C=48 channels and T=336 steps, hidden h=6:
    # N*T*(10*C*h + 15*(h + C)) = 344064 * 3690; 4 B * (2*N*C*T + 5*C*h + 3*h + 5*C)
    flops, nbytes = bounds.dconv_sub_block((1024, 48, 336), (6, 48, 3))
    assert (flops, nbytes) == (1_269_596_160, 132_127_368)
    assert bounds.least_seconds(flops, nbytes)[1] == "bytes"


def test_bilstm_recurrence_k6():
    # T=336, B=2, H=192: 16*T*B*H^2; 4 B * (T*2*B*4H + 2*H*4H + T*2*B*H)
    assert bounds.bilstm_recurrence((336, 2, 2, 768), (2, 192, 768)) == (396_361_728,
                                                                          6_340_608)


def test_roofline_reader_sums_least_time_over_device_time():
    q = [2, 8, 2688, 64]
    summary = types.SimpleNamespace(op_shapes={"flash_mha": [[q, q, q]] * 4},
                                    kernel_s={"void mha_fwd_kernel<float, 64>(...)": 4e-3,
                                              "gemm": 1.0})
    run = types.SimpleNamespace(summary=summary)
    assert readers.roofline(run, "flash_mha") == pytest.approx(
        100 * 4 * 29_595_009_024 / 495e12 / 4e-3)
    assert readers.roofline(run, "bilstm_recurrence") is None
    summary.kernel_s = {"gemm": 1.0}
    assert readers.roofline(run, "flash_mha") is None


@pytest.mark.parametrize("config", ["htdemucs_4s", "hdemucs_mmi"])
def test_configuration_operation_counts(config):
    cfg = core.load_json(core.BENCH / "configs" / f"{config}.json")
    seg = cfg["apply"]["segment_samples"]
    assert count_operations(cfg, seg) == cfg["operations_per_segment"]
    if config == "htdemucs_4s":  # hdemucs_mmi's backward count takes a minute
        assert count_operations(cfg, seg, backward=True) == \
            cfg["training_operations_per_segment"]
    assert torch.__version__
