"""The port's tracer (utils/timing.py): spans in the sampling loop and the DiT.

Off (no profiler recording): a span records nothing, enters no
``record_function`` range, makes no CUDA event and counts nothing.  On, under
``torch.profiler.profile()`` on the CPU: two ``TrajCrafterPipeline._denoise``
steps of a two-layer DiT (bf16 widths cut to 2 heads of 16, fp32) count the
spans of the table in models/dit.py, the ``linear`` count is the number of
linear layers ``benchmark/work.py dit_step_ops`` counts at these widths, the
self times partition the profiler's own ``sampler.step`` ranges, and every
span is a host event of the profiler.  The same with the blocks and
Perceivers quantized to int8.  Work on the CPU keeps the host clock in a
process that has initialised a card.  ``StageTimer`` keeps its seconds and
opens ``stage.<name>``, which ``tools/profile_dit_step.py --clip`` reads.
"""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import work  # noqa: E402
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel  # noqa: E402
from trajectorycrafter_tpu_torch.ops.int8 import quantize_dit_  # noqa: E402
from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample  # noqa: E402
from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline  # noqa: E402
from trajectorycrafter_tpu_torch.schedulers import SCHEDULER_REGISTRY  # noqa: E402
from trajectorycrafter_tpu_torch.utils import timing  # noqa: E402

STEPS = 2
TINY = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, time_embed_dim=32,
            text_embed_dim=32, max_text_seq_length=8, cross_attn_num_heads=2,
            cross_attn_dim_head=16, sample_size=[64, 64], video_length=9, ref_frames=5)


def tiny_cfg(quant: str) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / "tc5b-int8-384x672.json").read_text())
    return {**cfg, **TINY, "quant": quant}


def tiny_loop(quant: str):
    """-> (cfg, a function running ``STEPS`` CFG steps of the sampling loop)."""
    cfg = tiny_cfg(quant)
    torch.manual_seed(0)
    dit = CrossTransformer3DModel(
        num_attention_heads=cfg["num_attention_heads"],
        attention_head_dim=cfg["attention_head_dim"], in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"], time_embed_dim=cfg["time_embed_dim"],
        text_embed_dim=cfg["text_embed_dim"], num_layers=cfg["num_layers"],
        max_text_seq_length=cfg["max_text_seq_length"], patch_size=cfg["patch_size"],
        cross_attn_interval=cfg["cross_attn_interval"],
        cross_attn_dim_head=cfg["cross_attn_dim_head"],
        cross_attn_num_heads=cfg["cross_attn_num_heads"]).eval()
    if quant == "int8":
        quantize_dit_(dit)
    pipe = TrajCrafterPipeline(vae=None, transformer=dit,
                               scheduler=SCHEDULER_REGISTRY[cfg["sampler_name"]](),
                               dtype=torch.float32)
    steps = cfg["num_inference_steps"]
    state = pipe.scheduler.set_timesteps(steps)
    hs, ws = cfg["sample_size"]
    f, h, w = (cfg["video_length"] - 1) // 4 + 1, hs // 8, ws // 8
    f_ref = (cfg["ref_frames"] - 1) // 4 + 1
    cos, sin = rope_for_sample(cfg["attention_head_dim"], hs, ws, f)
    rope = (torch.from_numpy(cos), torch.from_numpy(sin))
    text = torch.randn(2, cfg["max_text_seq_length"], cfg["text_embed_dim"])
    inpaint, ref = torch.randn(2, f, h, w, 17), torch.randn(2, f_ref, h, w, 16)
    latents = torch.randn(1, f, h, w, 16)

    @torch.no_grad()
    def run():
        return pipe._denoise(state, latents, text, inpaint, ref, rope, steps, steps - STEPS,
                             cfg["guidance_scale"], True, False, None, None)

    return cfg, run


@pytest.fixture(scope="module", params=["none", "int8"])
def traced(request):
    """-> (cfg, span totals, the profiler's host events) of ``STEPS`` traced steps."""
    cfg, run = tiny_loop(request.param)
    for _ in range(2):  # warm the loop, then the profiler's first session
        timing.reset_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
    totals = timing.span_totals()
    timing.reset_spans()
    return cfg, totals, prof.events()


def expected_calls(cfg: dict) -> dict:
    """Spans a CFG step opens (models/dit.py), at ``cfg``'s layers."""
    layers = cfg["num_layers"]
    perceivers = len(range(0, layers, cfg["cross_attn_interval"]))
    linears = sum(op.count for op in work.dit_step_ops(cfg) if op.group == "linear")
    return {"sampler.step": 1, "dit.forward": 1, "dit.embed": 1, "dit.block": layers,
            "dit.norm": 2 * layers + perceivers + 1, "dit.joint_attn": layers,
            "dit.perceiver": perceivers, "dit.ff": layers, "linear": linears,
            "attention": layers + perceivers}


def test_off_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("traced with no profiler recording")

    _, run = tiny_loop("none")
    timing.reset_spans()
    monkeypatch.setattr(timing, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    run()
    with timing.span("outside", torch.device("cpu")):
        pass
    assert timing.span_totals() == {}
    assert not timing._TRACER.stack and len(timing._TRACER.marks) == 0


def test_counts_per_step(traced):
    cfg, totals, _ = traced
    calls = {name: total.calls for name, total in totals.items()}
    assert calls == {name: STEPS * n for name, n in expected_calls(cfg).items()}


def test_linear_spans_are_the_work_models_layers(traced):
    """At two layers: 2 time-embedding, 1 text, 4 adaLN, 6 q/k/v, 2 out, 4 FF,
    3 Perceiver, norm_out and proj_out linears a step."""
    cfg, totals, _ = traced
    assert totals["linear"].calls == STEPS * 24
    assert 24 == sum(op.count for op in work.dit_step_ops(cfg) if op.group == "linear")


def test_self_times_partition_the_step(traced):
    _, totals, events = traced
    steps = [e for e in events if e.name == "sampler.step"]
    assert len(steps) == STEPS
    whole = sum(e.time_range.elapsed_us() for e in steps) * 1e-6
    self_s = sum(total.self_s for total in totals.values())
    assert all(total.self_s > 0 for total in totals.values())
    assert abs(self_s - whole) <= 0.01 * whole


def test_work_on_the_cpu_keeps_the_host_clock_with_a_card_up(monkeypatch):
    """Spans time the device their outermost span's work lies on: the tiny
    loop on the CPU partitions its steps by the host clock even in a process
    that has initialised a card, and makes no CUDA event."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA event for work on the CPU")

    _, run = tiny_loop("none")
    run()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    timing.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    totals = timing.span_totals()
    timing.reset_spans()
    whole = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.name == "sampler.step") * 1e-6
    assert abs(sum(t.self_s for t in totals.values()) - whole) <= 0.01 * whole


def test_stage_table_reads_the_stage_spans(capsys):
    """``tools/profile_dit_step.py --clip`` prints per stage its host
    seconds, the device's busy time inside its ``stage.<name>`` ranges and
    the span's self time: depth busy 4 of 10 ms, denoise 16 of 20."""
    import importlib.util

    from benchmark.trace import Trace

    spec = importlib.util.spec_from_file_location("profile_dit_step",
                                                  ROOT / "tools" / "profile_dit_step.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ms = 1_000_000
    trace = Trace(0, 30 * ms, [("k", 2 * ms, 6 * ms), ("k", 12 * ms, 28 * ms)],
                  [("stage.depth", 0, 10 * ms), ("stage.denoise", 10 * ms, 30 * ms)])
    totals = {"stage.depth": timing.SpanTotal(0.004, 1),
              "stage.denoise": timing.SpanTotal(0.0006, 1)}
    tool.stage_table(trace, totals, {"depth": 0.010, "denoise": 0.020})
    rows = {line.split()[0]: line.split()[1:] for line in capsys.readouterr().out.splitlines()}
    assert rows["depth"] == ["0.010", "0.004", "40.0%", "0.004", "x1"]
    assert rows["denoise"] == ["0.020", "0.016", "80.0%", "0.001", "x1"]


def test_every_span_is_a_profiler_event(traced):
    _, totals, events = traced
    names = {e.name for e in events}
    assert set(totals) <= names


@pytest.mark.parametrize("traced_on", [False, True])
def test_stage_timer(traced_on):
    timer = timing.StageTimer("cpu")
    timing.reset_spans()
    if traced_on:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                with timer("denoise"):
                    with timing.span("sampler.step", timer.device):
                        torch.ones(64, 64).matmul(torch.ones(64, 64))
        assert "stage.denoise" in {e.name for e in prof.events()}
    else:
        with timer("denoise"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    totals = timing.span_totals()
    timing.reset_spans()
    assert set(timer.seconds) == {"denoise"} and timer.seconds["denoise"] > 0
    if traced_on:
        assert {name: t.calls for name, t in totals.items()} == {"stage.denoise": 2,
                                                                 "sampler.step": 2}
        assert sum(t.self_s for t in totals.values()) <= timer.seconds["denoise"]
    else:
        assert totals == {}
