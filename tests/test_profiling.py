"""utils/profiling trace reduction on a small recorded-style trace: the GPU
planes are selected, host planes ignored, a trace without a GPU plane
raises, and kernels join to the frame's named stages."""

import pytest

from sunray_tpu.utils import profiling as prof

# The shape of a jax.profiler .trace.json.gz on one GPU: a metadata event
# names each process (plane); device kernels are complete ("X") events.
EVENTS = [
    {"ph": "M", "pid": 1, "name": "process_name",
     "args": {"name": "/host:CPU"}},
    {"ph": "M", "pid": 2, "name": "process_name",
     "args": {"name": "/device:GPU:0"}},
    {"ph": "X", "pid": 1, "tid": 1, "name": "PjitFunction(step)",
     "ts": 0.0, "dur": 900.0},
    {"ph": "X", "pid": 2, "tid": 7, "name": "loop_fusion_3",
     "ts": 10.0, "dur": 300.0},
    {"ph": "X", "pid": 2, "tid": 7, "name": "trace_closest__1",
     "ts": 320.0, "dur": 500.0},
    {"ph": "X", "pid": 2, "tid": 7, "name": "loop_fusion_3",
     "ts": 830.0, "dur": 100.0},
]

HLO = """
  %loop_fusion.3 = f32[8]{0} fusion(%p), kind=kLoop, metadata={op_name="jit(step)/ris_pass/ris_audition/mul"}
  %custom-call.2 = (f32[8]{0}) custom-call(%a), metadata={op_name="jit(step)/final_pass/spatial_reuse/trace/pallas_call"}
  %copy.1 = f32[8]{0} copy(%x), metadata={op_name="jit(step)/denoise/copy"}
"""


def test_selects_gpu_planes_only():
    xs = prof.device_events(EVENTS)
    assert {e["name"] for e in xs} == {"loop_fusion_3", "trace_closest__1"}
    rows = prof.summarize_trace("", top=0, steady_frac=1.0, events=EVENTS)
    by = {r["name"]: r for r in rows}
    assert by["loop_fusion_3"]["count"] == 2
    assert by["loop_fusion_3"]["total_ms"] == pytest.approx(0.4)
    assert by["trace_closest__1"]["total_ms"] == pytest.approx(0.5)
    assert sum(r["pct"] for r in rows) == pytest.approx(100.0)


def test_host_only_trace_raises():
    host = [e for e in EVENTS if e["pid"] == 1]
    with pytest.raises(ValueError, match="no /device:GPU"):
        prof.device_events(host)


def test_stage_table_joins_named_stages():
    """GPU kernels carry the HLO instruction name with "." -> "_"; Pallas
    kernels carry their own name (plus a suffix)."""
    stage_of = prof.hlo_stage_map(HLO)
    assert stage_of == {"loop_fusion_3": "ris_audition",
                        "custom_call_2": "trace", "copy_1": "denoise"}
    rows = prof.summarize_trace("", top=0, steady_frac=1.0, events=EVENTS)
    table = prof.stage_table(rows, stage_of, frames=2)
    assert table == pytest.approx({"trace": 0.25, "ris_audition": 0.2})
