"""Pins the analytic HBM-traffic lower bound (utils/roofline.py) — the
frame-floor arithmetic a roofline share rests on — and its peak table."""

import numpy as np
import pytest

from sunray_tpu.config import RenderConfig
from sunray_tpu.utils import roofline as rl

H100 = "NVIDIA H100 80GB HBM3"


def test_stage_set_matches_pipeline():
    cfg = RenderConfig(width=1920, height=1080, lighting="restir")
    stages = rl.frame_traffic_lower_bound(cfg)
    names = [s.name for s in stages]
    # Pass order mirrors render/pipeline.render_frame (and the
    # reference's build_unified_graph, src/lib.rs:1347-1619).
    assert names == ["ris_pass", "final_pass", "taa", "denoise",
                     "postprocess"]


def test_disabled_stages_drop_out():
    cfg = RenderConfig(width=64, height=48, enable_taa=False,
                       denoise_passes=0)
    names = [s.name for s in rl.frame_traffic_lower_bound(cfg)]
    assert "taa" not in names and "denoise" not in names


def test_bound_scales_with_pixels():
    lo = RenderConfig(width=640, height=360)
    hi = RenderConfig(width=1920, height=1080)
    b_lo = sum(s.bytes for s in rl.frame_traffic_lower_bound(lo))
    b_hi = sum(s.bytes for s in rl.frame_traffic_lower_bound(hi))
    assert abs(b_hi / b_lo - 9.0) < 1e-6  # 9x the pixels -> 9x the bytes


def test_postprocess_floor_exact():
    """One stage pinned exactly so a silent counting change can't pass."""
    cfg = RenderConfig(width=1920, height=1080)
    post = [s for s in rl.frame_traffic_lower_bound(cfg)
            if s.name == "postprocess"][0]
    # read HDR (P,3) + write LDR (P,3), f32.
    assert post.bytes == 2 * 4 * 1920 * 1080 * 3


def test_1080p_floor_magnitude():
    """The headline number: the full-pipeline 1080p dataflow floor moves
    multiple GB, about a millisecond at the H100's 3.35 TB/s; the report's
    floor_fraction is floor / measured."""
    cfg = RenderConfig(width=1920, height=1080, lighting="restir")
    stages = rl.frame_traffic_lower_bound(cfg, ris_rounds=2, final_rounds=2)
    floor = rl.total_floor_ms(stages, rl.peaks_for(H100).hbm_gbps)
    assert 0.5 < floor < 2.5, floor
    rep = rl.roofline_report(cfg, H100, measured_ms=40.0)
    assert np.isclose(rep["floor_fraction"], rep["floor_ms"] / 40.0,
                      atol=1e-3)
    assert rep["total_mbytes"] > 1000  # multi-GB traffic even as a bound


def test_report_json_roundtrips():
    import json

    cfg = RenderConfig(width=480, height=270)
    rep = rl.roofline_report(cfg, H100, measured_ms=12.3)
    js = json.loads(json.dumps(rep))
    assert js["stages"][0]["stage"] == "ris_pass"
    assert np.isclose(
        sum(s["floor_ms"] for s in js["stages"]), js["floor_ms"], atol=0.05
    )


def test_peak_table_h100_row():
    """The H100 row carries the data-sheet rates and its source."""
    pk = rl.peaks_for(H100)
    assert (pk.hbm_gbps, pk.f32_tflops, pk.tf32_tflops, pk.bf16_tflops) == (
        3350.0, 67.0, 495.0, 989.0)
    assert "data sheet" in pk.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"])
def test_unknown_device_raises(kind):
    """A device without a row is an error, never a default peak."""
    with pytest.raises(ValueError, match="no published peaks"):
        rl.peaks_for(kind)
    with pytest.raises(ValueError):
        rl.roofline_report(RenderConfig(width=64, height=48), kind)
