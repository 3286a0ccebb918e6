"""The port's PiDiNet, HED, lineart, NormalBAE and OpenPose extractors against
the JAX package, on the CPU in fp32.

Each network loads one seeded checkpoint in the released key layout: the
JAX tests' torch oracles (``tests/test_pidinet.py:_TorchPiDiNet`` at the
table-5 widths, ``test_hed.py:_TorchHED``, ``test_lineart.py:_TorchGenerator``
at 2 residual blocks, ``test_normalbae.py:_TorchNNET`` at its thin config,
``test_openpose.py:_TorchBody``) with values drawn from numpy, saved as the
released files are (``{"state_dict": ...}`` with ``module.`` prefixes for
PiDiNet, ``{"model": ...}`` with them and the dead ``bn2`` entries for NNET,
the bare state dict for the others). The port loads the file strictly; the
JAX class reads the same file through its converter.

- Each network against its flax module on one input, within 1e-4 of the
  largest output (PiDiNet covers cd, ad, rd and cv: ``CARV4``).
- Each detector end to end against the JAX class on the same frames (odd
  sizes, so the padding is exercised): uint8 maps within one step; HED
  scribble and ``OpenposeDetector`` bit for bit (at least 99.9 % of the
  pixels asked first). OpenPose's JAX class resizes the uint8 frame with
  cv2, whose IPP HAL rounds a few pixels differently from OpenCV's own
  arithmetic (``ops/resize.py:resize_cubic``), so it runs here with IPP off.
- ``find_peaks``, ``score_connections``, ``assemble_subsets`` and
  ``draw_bodypose`` equal to the JAX functions on constructed fields
  (``chip_smoke.pose_fields``: two people of 6 parts each), a crossing pair
  whose greedy order decides the match, an empty map; the digest of the JAX
  canvas that ``chip_smoke.py`` holds the card host's drawing to.
- ``chip_smoke.py``'s fabricated checkpoints have the oracles' names and
  shapes at the published widths.
- ``ConditionExtractor`` picks each network from its ``.pth`` / ``.pt`` path,
  batches frames of one shape, and refuses a type without one (or a
  ``.safetensors`` HED) before any network loads.
- ``train_torch.main`` on a PNG-frame clip with softedge and openpose
  extracted through ``CTRL_ADAPTER_ANNOTATORS`` (thin towers, one step).
- ``utils/profiling.py``: ``trace`` writes a Chrome trace, as the JAX
  module's ``trace`` writes its profile, holding a span recorded inside it;
  the recording holds it too, and outside a recording a span is the shared
  no-op.

One JAX compile per network (the JAX detector's own jitted apply serves the
network check); torch at one thread.
"""

import argparse
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ctrl_adapter_tpu_torch.conditions import extractors as tex
from ctrl_adapter_tpu_torch.conditions import hed as thed
from ctrl_adapter_tpu_torch.conditions import lineart as tlineart
from ctrl_adapter_tpu_torch.conditions import normalbae as tnormal
from ctrl_adapter_tpu_torch.conditions import openpose as topenpose
from ctrl_adapter_tpu_torch.conditions import pidinet as tpidinet
from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel

from . import torch_cli_common as tc
from .test_hed import _TorchHED
from .test_lineart import _TorchGenerator
from .test_normalbae import DEC, HEAD, STAGES, STEM, _TorchNNET
from .test_openpose import _TorchBody
from .test_pidinet import _TorchPiDiNet

torch.set_num_threads(1)

NET_TOL = 1e-4
H, W = 37, 45  # odd: every detector pads


def _frames(n, seed, h=H, w=W):
    """Smooth frames with sharp-edged shapes: structure for the edge nets."""
    rng = np.random.default_rng(seed)
    out = []
    for fr in chip_smoke.smooth_frames(rng, n, max(h, w)):
        fr = fr[:h, :w].astype(np.int32)
        for _ in range(3):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            fr[y: y + rng.integers(4, h // 2), x: x + rng.integers(4, w // 2)] = rng.integers(
                0, 256, 3)
        out.append(np.clip(fr, 0, 255).astype(np.uint8))
    return out


def _seeded(module, seed, gain=1.0, bias=0.1):
    """``module``'s state dict drawn from ``default_rng(seed)``: conv weights
    N(0, gain^2 / fan_in), biases and other vectors N(0, bias^2), BN
    weights 1 + N / 10, running variances 1 + |N| / 2, counters kept."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in module.state_dict().items():
        if not v.is_floating_point():
            out[name] = v.clone()
            continue
        draw = torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
        if name.endswith("running_var"):
            out[name] = 1 + 0.5 * draw.abs()
        elif name.endswith("running_mean"):
            out[name] = 0.1 * draw
        elif v.ndim >= 3:
            out[name] = draw * gain / float(np.sqrt(v[0].numel()))
        elif name.endswith("weight") and ".bn" in name or "_net.1." in name or "_net.4." in name:
            out[name] = 1 + 0.1 * draw if name.endswith("weight") else bias * draw
        else:
            out[name] = bias * draw
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close_maps(got, want, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.uint8
        diff = np.abs(g.astype(int) - w)
        if exact:
            assert (diff == 0).mean() >= 0.999
            np.testing.assert_array_equal(g, w)
        assert diff.max() <= 1


# ------------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{name: path} of the five seeded released-layout checkpoints."""
    root = tmp_path_factory.mktemp("annotators")
    torch.manual_seed(0)
    out = {}
    pidi = _seeded(_TorchPiDiNet(c=60, dil=24), 1)
    out["softedge"] = str(root / "table5_pidinet.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in pidi.items()}}, out["softedge"])
    hed = _seeded(_TorchHED(), 2, gain=0.8, bias=0.0)
    hed["norm"] = torch.tensor([[[[120.0]], [[110.0]], [[100.0]]]])
    for i in range(1, 6):  # sparse edges: about a fifth of the pixels above 127
        hed[f"block{i}.projection.bias"] -= 5.0
    out["scribble"] = str(root / "ControlNetHED.pth")
    torch.save(hed, out["scribble"])
    out["lineart"] = str(root / "sk_model.pth")
    torch.save(_seeded(_TorchGenerator(n_residual_blocks=2), 3), out["lineart"])
    nnet = _TorchNNET()
    sd = {f"module.encoder.original_model.{k}": v for k, v in
          _seeded(nnet.encoder, 4).items()}
    sd.update({f"module.decoder.{k}": v for k, v in _seeded(nnet.decoder, 5).items()})
    for leaf, v in (("weight", torch.ones(HEAD)), ("bias", torch.zeros(HEAD)),
                    ("running_mean", torch.zeros(HEAD)), ("running_var", torch.ones(HEAD)),
                    ("num_batches_tracked", torch.tensor(7))):
        sd[f"module.encoder.original_model.bn2.{leaf}"] = v  # dead in NNET, as released
    out["normal"] = str(root / "scannet.pt")
    torch.save({"model": sd}, out["normal"])
    body = _seeded(_TorchBody(), 6, gain=1.0)
    body["Mconv7_stage6_L2.bias"] = torch.full((19,), 0.12)
    out["openpose"] = str(root / "body_pose_model.pth")
    torch.save(body, out["openpose"])
    return out


# ------------------------------------------------------------- the networks
def test_pidinet_matches_jax(ckpts):
    from ctrl_adapter_tpu.conditions.pidinet import SoftEdgePidiNet

    jdet = SoftEdgePidiNet(ckpts["softedge"])
    port = tpidinet.SoftEdgePidiNet(ckpts["softedge"], device="cpu")
    assert port.model.pdcs == tpidinet.CARV4 and set(tpidinet.CARV4[:4]) == {"cd", "ad", "rd",
                                                                             "cv"}
    x = np.random.default_rng(7).uniform(0, 1, (1, 40, 48, 3)).astype(np.float32)
    want = np.asarray(jdet._apply(jdet.params, jnp.asarray(x)))
    with torch.no_grad():
        got = port.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert _rel(got, want) <= NET_TOL
    frames = _frames(2, 8)
    _close_maps(port(frames), jdet(frames))
    _close_maps(port(frames, safe=True), jdet(frames, safe=True))


def test_hed_and_scribble_match_jax(ckpts):
    from ctrl_adapter_tpu.conditions.hed import ScribbleHED

    jdet = ScribbleHED(ckpts["scribble"])
    port = thed.ScribbleHED(ckpts["scribble"], device="cpu")
    frames = _frames(2, 9)
    x = frames[0][None].astype(np.float32)
    want = np.asarray(jdet._apply(jdet.params, jnp.asarray(x)))
    with torch.no_grad():
        got = port.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert _rel(got, want) <= NET_TOL
    soft = jdet(frames, scribble=False)
    _close_maps(port(frames, scribble=False), soft)
    assert 0.05 < (soft[0] > 127).mean() < 0.5  # the suppression has work
    scribbles = jdet(frames, scribble=True)
    assert 0.01 < (scribbles[0] == 255).mean() < 0.99
    _close_maps(port(frames, scribble=True), scribbles, exact=True)


def test_lineart_matches_jax(ckpts):
    from ctrl_adapter_tpu.conditions.lineart import LineartDetector

    jdet = LineartDetector(ckpts["lineart"], n_residual_blocks=2)
    port = tlineart.LineartDetector(ckpts["lineart"], device="cpu", n_residual_blocks=2)
    x = np.random.default_rng(10).uniform(0, 1, (1, 40, 48, 3)).astype(np.float32)
    want = np.asarray(jdet._apply(jdet.params, jnp.asarray(x)))
    with torch.no_grad():
        got = port.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert _rel(got, want) <= NET_TOL
    frames = _frames(2, 11)
    _close_maps(port(frames), jdet(frames))
    _close_maps(port(frames, invert=False), jdet(frames, invert=False))


def test_normalbae_matches_jax(ckpts):
    from ctrl_adapter_tpu.conditions.normalbae import NNET, NormalBaeDetector, \
        convert_nnet_state_dict

    ckpt = torch.load(ckpts["normal"], weights_only=True)
    sd = {k.removeprefix("module."): v.numpy() for k, v in ckpt["model"].items()}
    model = NNET(stem=STEM, stages=STAGES, head=HEAD, decoder_dims=DEC)
    apply = jax.jit(model.apply)
    jdet = NormalBaeDetector.__new__(NormalBaeDetector)  # the class at the thin config
    jdet.model, jdet.params = model, {"params": convert_nnet_state_dict(sd, stages=STAGES)}
    jdet._apply = lambda p, x: apply(p, x)[-1]
    port = tnormal.NormalBaeDetector(ckpts["normal"], device="cpu", stem=STEM, stages=STAGES,
                                     head=HEAD, decoder_dims=DEC)
    x = np.random.default_rng(12).standard_normal((1, 64, 64, 3)).astype(np.float32)
    wants = apply(jdet.params, jnp.asarray(x))
    with torch.no_grad():
        gots = port.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(gots) == len(wants) == 4
    for got, want in zip(gots, wants):
        assert _rel(got.permute(0, 2, 3, 1).numpy(), want) <= NET_TOL
    frames = _frames(2, 13)
    _close_maps(port(frames), jdet(frames))


def test_openpose_matches_jax(ckpts):
    import cv2

    from ctrl_adapter_tpu.conditions import openpose as jopenpose

    jdet = jopenpose.OpenposeDetector(ckpts["openpose"])
    port = topenpose.OpenposeDetector(ckpts["openpose"], device="cpu")
    frames = _frames(2, 14)
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        jmaps = [jdet._forward(f[:, :, ::-1].copy()) for f in frames]
        jposes = [jdet.detect_poses(f) for f in frames]
        want = jdet(frames)
    finally:
        cv2.ipp.setUseIPP(ipp)
    paf, heat = port.maps(np.stack(frames))
    for i, (jpaf, jheat) in enumerate(jmaps):
        assert _rel(paf[i].numpy(), jpaf) <= NET_TOL and _rel(heat[i].numpy(), jheat) <= NET_TOL
        peaks = topenpose.find_peaks(heat[i])
        jpeaks = jopenpose.find_peaks(jheat)
        assert [[p[:2] for p in part] for part in peaks] == [[p[:2] for p in part]
                                                             for part in jpeaks]
        assert sum(map(len, peaks)) > 0  # the decoding has peaks to score
        candidate, subset = port.detect_poses(frames[i])
        np.testing.assert_allclose(candidate, jposes[i][0], rtol=1e-4, atol=0)
        np.testing.assert_array_equal(subset, jposes[i][1])
    _close_maps(port(frames), want, exact=True)


# ------------------------------------------------------- the pose decoding
@pytest.mark.parametrize("case", ["two_people", "empty"])
def test_pose_decoding_matches_jax(case):
    from ctrl_adapter_tpu.conditions import openpose as jopenpose

    heat, paf = chip_smoke.pose_fields()
    if case == "empty":
        heat[:] = 0
    peaks = topenpose.find_peaks(torch.from_numpy(heat))
    jpeaks = jopenpose.find_peaks(heat)
    assert peaks == jpeaks
    conns = topenpose.score_connections(torch.from_numpy(paf), peaks, heat.shape[0])
    jconns = jopenpose.score_connections(paf, jpeaks, heat.shape[0])
    assert len(conns) == len(jconns) == 19
    for c, j in zip(conns, jconns):
        np.testing.assert_array_equal(c, j)
    candidate, subset = topenpose.assemble_subsets(peaks, conns)
    jcandidate, jsubset = jopenpose.assemble_subsets(jpeaks, jconns)
    np.testing.assert_array_equal(candidate, jcandidate)
    np.testing.assert_array_equal(subset, jsubset)
    canvas = topenpose.draw_bodypose(96, 96, candidate, subset)
    np.testing.assert_array_equal(canvas, jopenpose.draw_bodypose(96, 96, jcandidate, jsubset))
    if case == "empty":
        assert not any(peaks) and len(subset) == 0 and not canvas.any()
    else:
        assert [len(peaks[i - 1]) for i in (1, 2, 3, 4, 6, 7)] == [2] * 6
        assert len(subset) == 2 and (subset[:, -1] >= 4).all()
        assert len(np.unique(canvas.reshape(-1, 3), axis=0)) > 10


def test_pose_fields_canvas_is_the_jax_one():
    """``chip_smoke.py`` draws ``pose_fields()`` on the card's host, which has
    no cv2, and holds the canvas to this digest of the JAX package's."""
    import hashlib

    from ctrl_adapter_tpu.conditions import openpose as jopenpose

    heat, paf = chip_smoke.pose_fields()
    peaks = jopenpose.find_peaks(heat)
    candidate, subset = jopenpose.assemble_subsets(
        peaks, jopenpose.score_connections(paf, peaks, heat.shape[0]))
    canvas = jopenpose.draw_bodypose(heat.shape[0], heat.shape[1], candidate, subset)
    assert hashlib.sha256(canvas.tobytes()).hexdigest() == chip_smoke.POSE_CANVAS_SHA256


@pytest.mark.parametrize("ctype", list(tex.ANNOTATORS))
def test_chip_smoke_writes_the_released_layouts(ctype):
    """``chip_smoke.annotator_release_shapes`` (what the card's run writes)
    holds the names and shapes of the JAX tests' oracles at the published
    widths; the NNET's at ``test_normalbae.py``'s thin config, with the
    released file's unused ``bn2``."""
    oracles = {"softedge": lambda: _TorchPiDiNet(c=60, dil=24), "scribble": _TorchHED,
               "lineart": _TorchGenerator, "openpose": _TorchBody}
    if ctype == "normal":
        nnet = _TorchNNET()
        want = {f"encoder.original_model.{k}": tuple(v.shape)
                for k, v in nnet.encoder.state_dict().items()}
        want.update({f"decoder.{k}": tuple(v.shape) for k, v in nnet.decoder.state_dict().items()})
        got, _ = chip_smoke.nnet_release_shapes(STEM, STAGES, HEAD, DEC)
        bn2 = {k: v for k, v in got.items() if k.startswith("encoder.original_model.bn2.")}
        assert set(bn2) == {f"encoder.original_model.bn2.{leaf}" for leaf in (
            "weight", "bias", "running_mean", "running_var", "num_batches_tracked")}
        assert {k: v for k, v in got.items() if k not in bn2} == want
        return
    want = {k: tuple(v.shape) for k, v in oracles[ctype]().state_dict().items()}
    assert chip_smoke.annotator_release_shapes()[ctype][0] == want


def test_greedy_order_decides_a_crossing_pair():
    """Two shoulder candidates, two elbow candidates: the stronger field pairs
    each shoulder with the elbow across, so taking pairs by score (and each
    end once) picks the crossing pair; both packages take the same."""
    from ctrl_adapter_tpu.conditions import openpose as jopenpose

    peaks = [[] for _ in range(18)]
    peaks[2] = [(20, 20, 0.9, 0), (60, 20, 0.8, 1)]   # part 3 (right shoulder)
    peaks[3] = [(20, 60, 0.9, 2), (60, 60, 0.7, 3)]   # part 4 (right elbow)
    paf = np.zeros((80, 80, 38), np.float32)
    cx, cy = topenpose.MAP_IDX[2][0] - 19, topenpose.MAP_IDX[2][1] - 19
    for (xa, ya), (xb, yb), s in (((20, 20), (60, 60), 1.0), ((60, 20), (20, 60), 0.9),
                                  ((20, 20), (20, 60), 0.3)):
        v = np.array([xb - xa, yb - ya], np.float32) / np.hypot(xb - xa, yb - ya)
        for t in np.linspace(0, 1, 60):
            y, x = int(round(ya + t * (yb - ya))), int(round(xa + t * (xb - xa)))
            paf[y, x, cx], paf[y, x, cy] = s * v[0], s * v[1]
    got = topenpose.score_connections(torch.from_numpy(paf), peaks, 80)[2]
    want = jopenpose.score_connections(paf, peaks, 80)[2]
    np.testing.assert_array_equal(got, want)
    assert [tuple(r[:2].astype(int)) for r in got] == [(0, 3), (1, 2)]


# ------------------------------------------------------------- the extractor
def test_condition_extractor_routes_the_five_types(ckpts, monkeypatch):
    def thin_normal(path, device):
        return tnormal.NormalBaeDetector(path, device=device, stem=STEM, stages=STAGES,
                                         head=HEAD, decoder_dims=DEC)

    def two_block_lineart(path, device):
        return tlineart.LineartDetector(path, device=device, n_residual_blocks=2)

    monkeypatch.setattr(tex, "NormalBaeDetector", thin_normal)
    monkeypatch.setattr(tex, "LineartDetector", two_block_lineart)
    ex = tex.ConditionExtractor(ckpts, device="cpu")
    frames = _frames(2, 15) + _frames(1, 16, 29, 33)  # two shapes: two batches
    kinds = {"softedge": tpidinet.SoftEdgePidiNet, "lineart": tlineart.LineartDetector,
             "normal": tnormal.NormalBaeDetector, "openpose": topenpose.OpenposeDetector}
    for ctype in tex.ANNOTATORS:
        maps = ex.extract(ctype, frames)
        assert [m.shape for m in maps] == [f.shape for f in frames]
        if ctype in kinds:
            assert isinstance(ex._estimators[ctype], kinds[ctype])
            single = [ex._estimators[ctype]([f])[0] for f in frames]
            for a, b in zip(maps, single):  # a batch gives each frame's own map
                assert np.abs(a.astype(int) - b).max() <= 1
    scribble = ex.extract("scribble", frames[:1])[0]
    assert set(np.unique(scribble)) <= {0, 255}


def test_annotator_paths_are_checked_before_any_network_loads(ckpts, tmp_path):
    loads = []
    for ctype, (_, released) in tex.ANNOTATORS.items():
        for paths in ({}, {ctype: str(tmp_path / "weights.bin")}):
            with pytest.raises(RuntimeError, match="CTRL_ADAPTER_ANNOTATORS") as err:
                tex.check_control_types(["depth", ctype], paths)
            assert released in str(err.value)
            ex = tex.ConditionExtractor(paths, device="cpu")
            ex._load = lambda *a: loads.append(a)
            with pytest.raises(RuntimeError, match=released):
                ex.add_estimator(ctype)
    assert not loads
    safetensors = str(tmp_path / "ControlNetHED.safetensors")
    with pytest.raises(RuntimeError, match="torch.load"):
        tex.check_control_types(["scribble"], {"scribble": safetensors})
    tex.check_control_types(list(tex.ANNOTATORS), ckpts)
    with pytest.raises(ValueError, match="unknown control type"):
        tex.check_control_types(["sketch"], ckpts)


@pytest.mark.parametrize("name", ["softedge", "openpose", "normal"])
def test_loaders_refuse_unknown_entries(ckpts, tmp_path, name):
    ckpt = torch.load(ckpts[name], weights_only=True)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd["module.extra.weight" if name != "openpose" else "extra.weight"] = torch.zeros(1)
    path = str(tmp_path / "bad.pth")
    torch.save(ckpt, path)
    make = {"softedge": tpidinet.SoftEdgePidiNet, "openpose": topenpose.OpenposeDetector,
            "normal": lambda p, device: tnormal.NormalBaeDetector(
                p, device=device, stem=STEM, stages=STAGES, head=HEAD, decoder_dims=DEC)}[name]
    with pytest.raises((KeyError, RuntimeError), match="extra"):
        make(path, device="cpu")


# ------------------------------------------------------- training on them
def test_train_cli_extracts_softedge_and_openpose(ckpts, tmp_path, monkeypatch):
    """``train_torch.main`` on a PNG-frame clip folder, mixed softedge /
    openpose batches extracted through ``CTRL_ADAPTER_ANNOTATORS`` (thin
    towers, one step each)."""
    import train_torch

    monkeypatch.setattr(train_torch, "build_modules", tc.thin_train_modules)
    types = ("softedge", "openpose")
    src = tc.thin_build_modules(argparse.Namespace(model_name="svd", control_types=["depth"]),
                                "cpu")
    flags = tc.train_flags(tc.write_thin_release(src, "svd", str(tmp_path / "release")))
    i = flags.index("--controlnet_model_paths")
    extra = MultiControlNetModel([src.controlnet] * 2).save_pretrained(str(tmp_path / "types"))
    flags = flags[:i + 1] + extra + flags[i + 2:]
    monkeypatch.setenv("CTRL_ADAPTER_ANNOTATORS", json.dumps(ckpts))
    clips, csv_path = chip_smoke.write_clip_folder(str(tmp_path / "clips"), 1, tc.FRAMES, 64,
                                                   seed=17)
    seen = []
    extract = tex.ConditionExtractor.extract

    def recorded(self, ctype, images):
        seen.append(ctype)
        return extract(self, ctype, images)

    monkeypatch.setattr(tex.ConditionExtractor, "extract", recorded)
    run = train_torch.main(["--model_name", "svd", "--height", "64", "--width", "64",
                            "--n_sample_frames", str(tc.FRAMES), "--mixed_precision", "no",
                            "--cross_attention_dim", "1024", "--max_train_steps", "2",
                            "--checkpointing_steps", "9", "--skip_conv_in", "True",
                            "--DATA_PATH", str(tmp_path / "out"), *flags,
                            "--train_data_path", clips, "--train_prompt_path", csv_path,
                            "--control_types", *types, "--mixed_control_types_training",
                            *types, "--seed", "1"], device="cpu")
    assert len(run.records) == 2 and all(np.isfinite(r["loss"]) for r in run.records)
    assert set(seen) <= set(types) and seen
    assert {t[0] for t in run.step_types} <= set(types)


# --------------------------------------------------------------- profiling
def test_profiling_matches_jax(tmp_path):
    from ctrl_adapter_tpu_torch.utils import profiling as tprof

    assert tprof.span("annotator_profiling_span") is tprof.span("another")
    with tprof.recording() as rec:
        with tprof.trace(str(tmp_path / "trace")):
            with tprof.span("annotator_profiling_span", clip=2):
                torch.ones(8) @ torch.ones(8)
    with open(tmp_path / "trace" / "trace.json") as fh:
        assert "annotator_profiling_span" in fh.read()
    (only,) = rec.spans
    assert only.name == "annotator_profiling_span" and only.ids == {"clip": 2}
    assert only.parent is None and only.start_ns <= only.end_ns
