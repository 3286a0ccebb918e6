"""The port's span recorder (``utils/profiling.py``) and the spans at its layer
boundaries, on the CPU.

- Off (no recording open): ``span`` hands out one shared no-op object.
- On: spans nest per thread, keep their ids, and a span opened on another
  thread has no parent on the main thread; recordings do not nest.
- Clock: under ``torch.profiler`` each recorded span holds the profiler
  range (event) of the same span, by a median 50 µs or less at either end.
- Pipelines: the thin SVD and I2VGen-XL pipelines of the CLI tests give one
  ``pipeline.generate``, a ``pipeline.step`` per step, the control towers
  exactly on the controlled steps, the UNet on every step, and one
  ``pipeline.decode`` holding the VAE's decode.
- Training: a thin SVD ``train_step`` with gradient checkpointing opens the
  UNet's and the adapter's spans again inside ``trainer.backward`` (the
  recompute) and one ``trainer.optimizer``.
- Plain paths: ``op.group_norm.plain`` fires exactly where the dispatch rule
  (``group_norm.use_kernel``) does not take K1, ``op.attention.plain``
  exactly where the attention is not K2's (``flash_eligible`` self-attention).
"""

import argparse
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from ctrl_adapter_tpu_torch.nn.attention import Attention
from ctrl_adapter_tpu_torch.nn.resnet import GroupNorm
from ctrl_adapter_tpu_torch.ops import flash_attention as fa
from ctrl_adapter_tpu_torch.ops import group_norm as gn
from ctrl_adapter_tpu_torch.pipelines.common import control_window
from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer, TrainConfig
from ctrl_adapter_tpu_torch.utils import profiling

from .torch_cli_common import thin_build_modules

HW, FRAMES, STEPS = 64, 3, 3


def _names(rec):
    return Counter(s.name for s in rec.spans)


def _ancestors(spans, i):
    """Names of the spans enclosing span ``i`` on its thread, innermost first."""
    out = []
    while spans[i].parent is not None:
        i = spans[i].parent
        out.append(spans[i].name)
    return out


def _below(spans, i):
    """Names of every span inside span ``i`` on its thread."""
    def inside(k):
        while spans[k].parent is not None:
            k = spans[k].parent
            if k == i:
                return True
        return False
    return [s.name for k, s in enumerate(spans) if inside(k)]


# ------------------------------------------------------------------ recorder
def test_span_is_one_shared_no_op_while_off():
    a = profiling.span("tower.unet")
    b = profiling.span("pipeline.step", step=3, controlled=True)
    assert a is b
    with a as entered:
        assert entered is a
    with profiling.recording() as rec:
        pass
    assert rec.spans == []


def test_spans_nest_per_thread_and_keep_ids():
    seen = {}

    def other():
        with profiling.span("side", k=7):
            seen["thread"] = threading.get_native_id()

    with profiling.recording() as rec:
        with profiling.span("outer", step=1):
            with profiling.span("inner"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
            with profiling.span("second"):
                pass
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert not t.is_alive()
    spans = rec.spans
    by = {s.name: (i, s) for i, s in enumerate(spans)}
    assert [s.name for s in spans] == ["outer", "inner", "side", "second"]
    assert by["outer"][1].parent is None and by["outer"][1].ids == {"step": 1}
    assert by["inner"][1].parent == by["outer"][0] and by["inner"][1].ids == {}
    assert by["second"][1].parent == by["outer"][0]
    side = by["side"][1]
    assert side.parent is None and side.ids == {"k": 7}
    assert side.thread == seen["thread"] != threading.get_native_id()
    assert all(s.thread == threading.get_native_id() for s in spans if s.name != "side")
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert by["outer"][1].start_ns <= by["inner"][1].start_ns
    assert by["inner"][1].end_ns <= by["second"][1].start_ns <= by["outer"][1].end_ns
    assert profiling.span("after") is profiling.span("again")


def test_recorded_spans_hold_their_profiler_events():
    """The spans' clock is the profiler's: each span's [start, end] holds its
    profiler event (to 5 µs, the profiler's conversion of its own clock), by
    a median 50 µs or less at either end (a median: on a loaded host a
    thread can be descheduled between the clock read and the event)."""
    x = torch.ones(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            with profiling.span("warm-up"):  # the first span pays for the op's first call
                x @ x
            for k in range(5):
                with profiling.span(f"clock.{k}"):
                    with profiling.span("clock.inner"):
                        x @ x
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("clock."):
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    spans = {}
    for s in rec.spans[1:]:
        spans.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    assert set(events) == set(spans) and len(spans["clock.inner"]) == 5
    lead, lag = [], []
    for name, got in spans.items():
        for (s0, s1), (e0, e1) in zip(sorted(got), sorted(events[name])):
            lead.append(e0 - s0)
            lag.append(s1 - e1)
    assert min(lead) >= -5_000 and min(lag) >= -5_000, (lead, lag)
    assert sorted(lead)[len(lead) // 2] <= 50_000 and sorted(lag)[len(lag) // 2] <= 50_000, (
        lead, lag)


def test_trace_export_holds_a_recorded_span(tmp_path):
    with profiling.recording():
        with profiling.trace(str(tmp_path / "trace")):
            with profiling.span("tower.exported"):
                torch.ones(8) @ torch.ones(8)
    with open(tmp_path / "trace" / "trace.json") as fh:
        assert '"tower.exported"' in fh.read()


# ------------------------------------------------------------------ pipelines
def _svd_inputs(g):
    return dict(image_embeddings=torch.randn(1, 1, 1024, generator=g),
                image_latent=torch.randn(1, HW // 8, HW // 8, 4, generator=g),
                controlnet_prompt_embeds=torch.randn(2, 77, 768, generator=g),
                control_images=torch.rand(FRAMES, HW, HW, 3, generator=g))


def _i2vgenxl_inputs(g):
    return dict(prompt_embeds=torch.randn(2, 77, 1024, generator=g),
                controlnet_prompt_embeds=torch.randn(2, 77, 768, generator=g),
                image_embeddings=torch.randn(1, 1, 1024, generator=g),
                first_frame_latent=torch.randn(1, HW // 8, HW // 8, 4, generator=g),
                control_images=torch.rand(FRAMES, HW, HW, 3, generator=g))


@pytest.mark.parametrize("model_name", ["svd", "i2vgenxl"])
def test_pipeline_spans(model_name):
    pipe = thin_build_modules(argparse.Namespace(model_name=model_name,
                                                 control_types=["depth"]), "cpu")
    g = torch.Generator().manual_seed(3)
    inputs = (_svd_inputs if model_name == "svd" else _i2vgenxl_inputs)(g)
    lo, hi = control_window(STEPS, 0.0, 0.7)
    assert 0 < hi - lo < STEPS
    with profiling.recording() as rec:
        video = pipe.generate(**inputs, height=HW, width=HW, num_frames=FRAMES,
                              num_inference_steps=STEPS, control_guidance_end=0.7,
                              control_latent_size=HW // 8, generator=g)
    assert video.shape[:2] == (1, FRAMES) and torch.isfinite(video).all()
    spans = rec.spans
    names = _names(rec)
    assert names["pipeline.generate"] == 1 and names["pipeline.decode"] == 1
    steps = [i for i, s in enumerate(spans) if s.name == "pipeline.step"]
    assert [spans[i].ids["step"] for i in steps] == list(range(STEPS))
    for i in steps:
        step = spans[i].ids["step"]
        below = Counter(_below(spans, i))
        controlled = lo <= step < hi
        assert spans[i].ids["controlled"] == controlled
        assert _ancestors(spans, i) == ["pipeline.generate"]
        assert below["tower.unet"] == 1
        assert below["tower.controlnet"] == below["tower.adapter"] == int(controlled)
        assert below["pipeline.guidance"] >= 1
        assert below["block.mid"] == 1 + int(controlled)
    decode = next(i for i, s in enumerate(spans) if s.name == "pipeline.decode")
    assert spans[decode].ids == {"clip": 0} and spans[decode].parent is not None
    assert Counter(_below(spans, decode))["tower.vae_decode"] >= 1
    assert names["op.group_norm.plain"] > 0 and names["op.attention.plain"] > 0
    with profiling.recording() as rec:
        pipe.generate(**inputs, height=HW, width=HW, num_frames=FRAMES, num_inference_steps=1,
                      control_latent_size=HW // 8, output_type="latent", generator=g)
    generate = [s for s in rec.spans if s.name == "pipeline.generate"]
    assert [s.ids for s in generate] == [{"clip": 1}] and _names(rec)["pipeline.decode"] == 0


# ------------------------------------------------------------------ training
def test_train_step_spans_and_recompute():
    pipe = thin_build_modules(argparse.Namespace(model_name="svd", control_types=["depth"]),
                              "cpu")
    pipe.adapter.requires_grad_(True)
    cfg = TrainConfig(model_name="svd", n_sample_frames=FRAMES, control_latent_size=HW // 8,
                      skip_conv_in=True, output_fps=7, gradient_checkpointing=True)
    trainer = CtrlAdapterTrainer(cfg, pipe.unet, pipe.controlnet, pipe.adapter, pipe.vae,
                                 device="cpu")
    rng = np.random.default_rng(0)
    batch = {"frames": rng.uniform(-1, 1, (1, FRAMES, HW, HW, 3)),
             "controlnet_cond": rng.uniform(0, 1, (1, FRAMES, HW, HW, 3)),
             "controlnet_text_emb": rng.standard_normal((1, 77, 768)),
             "image_embeddings": rng.standard_normal((1, 1, 1024))}
    batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in batch.items()}
    g = torch.Generator().manual_seed(0)
    trainer.train_step(batch, generator=g)
    with profiling.recording() as rec:
        out = trainer.train_step(batch, generator=g)
    assert torch.isfinite(out["loss"])
    spans = rec.spans
    names = _names(rec)
    assert names["trainer.step"] == names["trainer.forward"] == names["trainer.backward"] == 1
    assert names["trainer.grads"] == names["trainer.optimizer"] == 1
    assert names["trainer.allreduce"] == 0
    assert {s.ids["step"] for s in spans if s.name.startswith("trainer.")} == {1}
    phases = [s.name for s in spans if s.name.startswith("trainer.")]
    assert phases == ["trainer.step", "trainer.forward", "trainer.backward", "trainer.grads",
                      "trainer.optimizer"]
    towers = {}
    for i, s in enumerate(spans):
        if s.name.startswith("tower."):
            phase = next(a for a in _ancestors(spans, i) if a.startswith("trainer."))
            towers.setdefault(phase, Counter())[s.name] += 1
    # the checkpointed UNet and adapter run again in the backward (the recompute)
    assert towers["trainer.forward"] == Counter({"tower.vae_encode": 1, "tower.controlnet": 1,
                                                 "tower.adapter": 1, "tower.unet": 1})
    assert towers["trainer.backward"] == Counter({"tower.adapter": 1, "tower.unet": 1})


# ------------------------------------------------------------------ plain paths
@pytest.mark.parametrize("flag", [None, "prefer", False])
@pytest.mark.parametrize("switch", [None, "1"])
def test_plain_group_norm_span_fires_where_k1_does_not(flag, switch, monkeypatch):
    if switch is None:
        monkeypatch.delenv("CTRL_ADAPTER_FUSED_GN", raising=False)
    else:
        monkeypatch.setenv("CTRL_ADAPTER_FUSED_GN", switch)
    shapes = [(2, 64, 8, 8), (2, 64, 2, 2), (1, 320, 96, 96), (2, 48, 4, 4)]
    for shape in shapes:
        norm = GroupNorm(16, shape[1], 1e-6, kernel=flag)
        with profiling.recording() as rec:
            y = norm(torch.randn(shape), silu=True)
        assert y.shape == shape
        takes = gn.use_kernel(flag, shape, 16, 4)
        assert _names(rec)["op.group_norm.plain"] == int(not takes), (shape, flag, switch)
    if flag == "prefer":  # the rule takes some of these shapes and refuses others
        assert {gn.use_kernel(flag, s, 16, 4) for s in shapes} == {True, False}


@pytest.mark.parametrize("tq,cross", [(1024, False), (16, False), (100, False), (1024, True),
                                      (20, True)])
def test_plain_attention_span_fires_where_k2_does_not(tq, cross):
    attn = Attention(64, heads=1, dim_head=64, cross_attention_dim=32 if cross else None)
    x = torch.randn(1, tq, 64)
    context = torch.randn(1, 7, 32) if cross else None
    with profiling.recording() as rec, torch.no_grad():
        y = attn(x, context)
    assert y.shape == x.shape
    k2 = not cross and fa.flash_eligible(tq, tq, 64)
    assert _names(rec)["op.attention.plain"] == int(not k2)


@pytest.mark.parametrize("h,tq,narrow", [(40, 1024, True), (80, 1024, True), (40, 256, False)])
def test_narrow_attention_span_stands_apart_from_the_plain_one(h, tq, narrow, monkeypatch):
    """A bf16 self-attention at head dim 40 or 80 and T >= 1024, with the card
    stood in for (``is_hopper`` true, ``attention_narrow`` its plain version),
    opens ``op.attention.narrow`` on (B, N, T, H) views and no
    ``op.attention.plain`` around or inside it; T = 256 stays plain. The
    output is the plain path's, bit for bit."""
    torch.manual_seed(0)
    attn = Attention(8 * h, heads=8, dim_head=h, dtype=torch.bfloat16)
    x = torch.randn(1, tq, 8 * h, dtype=torch.bfloat16)
    with torch.no_grad():
        want = attn(x)
    shapes = []

    def stand_in(q, k, v):
        shapes.append(tuple(q.shape))
        return fa._torch_attention(q, k, v)

    monkeypatch.setattr(fa, "is_hopper", lambda t: True)
    monkeypatch.setattr(fa, "attention_narrow", stand_in)
    with profiling.recording() as rec, torch.no_grad():
        got = attn(x)
    names = _names(rec)
    assert (names["op.attention.narrow"], names["op.attention.plain"]) == (narrow, not narrow)
    assert shapes == ([(1, 8, tq, h)] if narrow else [])
    for i, span in enumerate(rec.spans):
        if span.name == "op.attention.narrow":
            assert "op.attention.plain" not in _ancestors(rec.spans, i)
            assert not [s for s in rec.spans if s.parent == i]
    assert torch.equal(got, want)
