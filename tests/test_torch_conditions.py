"""The port's condition extraction against the JAX package, on the CPU in fp32.

- The three resizes of the extractors against ``jax.image.resize``
  (``bilinear_resize``, ``bicubic_resize``: antialiased when shrinking, Keys'
  a = -0.5, borders renormalised) and ``bilinear_resize_align_corners``, up
  and down, within 1e-5.
- The preprocessing without PIL or transformers: PIL's resampling bit for bit,
  and the DPT and SegFormer processors against transformers' within one uint8
  step (in the normalised units); a key it does not implement raises.
- ``DPTForDepthEstimation`` (at the native grid and an interpolated one), the
  SwinV2 backbone, ``DPTSwinDepthModel`` and SegFormer against their flax
  modules on one seeded state dict: transformers' names at thin widths
  (``tests/test_dpt.py``, ``tests/test_segformer.py``) or those of
  ``tests/torch_mirrors.py:DPTSwinT``, values drawn from numpy, loaded
  strictly by the port and converted by the JAX converters; within 1e-4 of
  the largest output (5e-4 for the Swin stacks, ``tests/test_dpt_swin.py``'s
  bound); SegFormer's argmax equal.
- ``DepthDPT``, ``DepthDPTSwin`` and ``SegmentationSegformer`` end to end
  against the JAX classes on the same folders: uint8 within one step.
- Canny against ``cv2.Canny`` (bit for bit on these frames; at least 99.9 %
  asked) and shuffle against the JAX function: at least 99 % of the pixels
  within one step. The port quantises the remap to 1/32 pixel as OpenCV 4's
  ``remap`` does; the installed cv2 5.0 samples at the float coordinate, so
  a pixel may differ by (|dI/dx| + |dI/dy|) / 64, at most 8 steps (on these
  frames: 99.76 % within one step, 3 at most).
- ``ConditionExtractor``'s choice of network by path, its refusals, and the
  depth correlation of ``evaluate_video``.

One JAX compile per network, at thin widths; torch at one thread.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ctrl_adapter_tpu_torch.conditions import extractors as tex
from ctrl_adapter_tpu_torch.conditions.processor import ImageProcessor, pil_resize
from ctrl_adapter_tpu_torch.ops import resize as tresize

from .torch_mirrors import DPTSwinT

torch.set_num_threads(1)


def _frames(n, h, w, seed):
    """Smooth frames with sharp-edged shapes and noise: edges for canny, detail
    for the resizes."""
    rng = np.random.default_rng(seed)
    out = []
    for fr in chip_smoke.smooth_frames(rng, n, max(h, w)):
        fr = fr[:h, :w].astype(np.int32)
        for _ in range(4):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            fr[y: y + rng.integers(4, h // 2), x: x + rng.integers(4, w // 2)] = rng.integers(
                0, 256, 3)
        fr += rng.integers(-12, 13, fr.shape)
        out.append(np.clip(fr, 0, 255).astype(np.uint8))
    return out


def _seeded(state, seed, scale):
    """A numpy copy of ``state`` drawn from ``default_rng(seed)``: norm weights
    1 + scale N(0, 1), running variances 1 + |N| / 2, the rest scale N(0, 1);
    integer tensors and the Swin buffers (index, table, masks) kept."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in state.items():
        v = v.numpy()
        if not np.issubdtype(v.dtype, np.floating) or any(
                k in name for k in ("relative_coords_table", "relative_position_index",
                                    "attn_mask")):
            out[name] = v
            continue
        draw = rng.standard_normal(v.shape).astype(np.float32)
        if name.endswith("running_var"):
            out[name] = 1 + 0.5 * np.abs(draw)
        elif name.endswith("weight") and any("norm" in p for p in name.split(".")[-3:-1]):
            out[name] = 1 + scale * draw
        else:
            out[name] = scale * draw
    return out


# ------------------------------------------------------------------- resizes
RESIZE_CASES = [((2, 5, 24, 24), (48, 48)), ((1, 3, 24, 30), (7, 11)),
                ((1, 3, 13, 17), (40, 9)), ((2, 4, 16, 16), (16, 5))]


@pytest.mark.parametrize("kind", ["bilinear_resize", "bicubic_resize",
                                  "bilinear_resize_align_corners"])
@pytest.mark.parametrize("shape,out", RESIZE_CASES, ids=[f"{s[2]}x{s[3]}->{o[0]}x{o[1]}"
                                                         for s, o in RESIZE_CASES])
def test_resizes_match_jax(kind, shape, out):
    from ctrl_adapter_tpu.ops import resize as jresize

    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = getattr(tresize, kind)(torch.from_numpy(x), out).numpy()
    want = np.asarray(getattr(jresize, kind)(jnp.asarray(x.transpose(0, 2, 3, 1)), out))
    assert got.shape == want.transpose(0, 3, 1, 2).shape
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5, rtol=0)


# ------------------------------------------------------------- preprocessing
@pytest.mark.parametrize("resample", [2, 3])
@pytest.mark.parametrize("shape,out", [((40, 52), (32, 32)), ((30, 20), (64, 48)),
                                       ((96, 96), (72, 120))])
def test_pil_resize_is_pils(resample, shape, out):
    from PIL import Image

    img = np.random.default_rng(1).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out[::-1], resample))
    np.testing.assert_array_equal(pil_resize(torch.from_numpy(img), out, resample).numpy(), want)


PROCESSOR_CASES = {
    "dpt": ("DPTImageProcessor", {"size": {"height": 32, "width": 32}}),
    "dpt-aspect": ("DPTImageProcessor", {"size": {"height": 32, "width": 32},
                                         "keep_aspect_ratio": True, "ensure_multiple_of": 8}),
    "segformer": ("SegformerImageProcessor", {"size": {"height": 48, "width": 40}}),
    # the released b5 file's keys, written as they stand
    "segformer-b5": ("SegformerImageProcessor", None),
}


@pytest.mark.parametrize("case", list(PROCESSOR_CASES))
def test_processors_match_transformers(case, tmp_path):
    import transformers

    from ctrl_adapter_tpu_torch.conditions import dpt, segformer

    cls, kwargs = PROCESSOR_CASES[case]
    if kwargs is None:
        with open(tmp_path / "preprocessor_config.json", "w") as fh:
            json.dump({**chip_smoke.SEGFORMER_PREPROCESSOR, "size": 64}, fh)
    else:
        getattr(transformers, cls)(**kwargs).save_pretrained(tmp_path)
    defaults = (dpt if cls.startswith("DPT") else segformer).PROCESSOR_DEFAULTS
    proc = ImageProcessor.from_pretrained(str(tmp_path), defaults)
    hf = getattr(transformers, cls).from_pretrained(str(tmp_path))
    imgs = _frames(2, 40, 56, 2)
    got = proc(imgs).numpy()
    want = hf(images=imgs, return_tensors="np")["pixel_values"]
    assert got.shape == want.shape
    step = 1 / 255 / min(proc.image_std)  # one uint8 step in the normalised units
    assert np.abs(got - want).max() <= step + 1e-6


def test_processor_refuses_what_it_does_not_implement(tmp_path):
    for extra, match in (({"do_center_crop": True}, "do_center_crop"),
                         ({"resample": 1}, "resample"),
                         ({"do_pad": True, "size_divisor": 32}, "do_pad"),
                         ({"size": {"shortest_edge": 32}}, "size")):
        with open(tmp_path / "preprocessor_config.json", "w") as fh:
            json.dump({"size": 32, **extra}, fh)
        with pytest.raises(ValueError, match=match):
            ImageProcessor.from_pretrained(str(tmp_path), {"size": 8, "resample": 3,
                                                           "image_mean": 0.5, "image_std": 0.5})


# ------------------------------------------------------------------- networks
@pytest.fixture(scope="module")
def dpt_dir(tmp_path_factory):
    """A thin transformers DPT folder with numpy-seeded weights (the names of
    ``transformers.DPTForDepthEstimation``)."""
    import transformers

    root = str(tmp_path_factory.mktemp("dpt"))
    cfg = transformers.DPTConfig(
        is_hybrid=False, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
        intermediate_size=64, image_size=32, patch_size=8, backbone_out_indices=[0, 1, 2, 3],
        neck_hidden_sizes=[16, 32, 64, 64], reassemble_factors=[4, 2, 1, 0.5],
        fusion_hidden_size=16, readout_type="project")
    hf = transformers.DPTForDepthEstimation(cfg).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in
                        _seeded(hf.state_dict(), 3, 0.2).items()})
    hf.save_pretrained(root, safe_serialization=True)
    transformers.DPTImageProcessor(size={"height": 32, "width": 32}).save_pretrained(root)
    return root


@pytest.fixture(scope="module")
def segformer_dir(tmp_path_factory):
    import transformers

    root = str(tmp_path_factory.mktemp("segformer"))
    cfg = transformers.SegformerConfig(
        num_labels=9, hidden_sizes=[8, 16, 24, 32], depths=[1, 1, 2, 1],
        num_attention_heads=[1, 2, 3, 4], sr_ratios=[8, 4, 2, 1], patch_sizes=[7, 3, 3, 3],
        strides=[4, 2, 2, 2], mlp_ratios=[2, 2, 2, 2], decoder_hidden_size=16,
        reshape_last_stage=True)
    hf = transformers.SegformerForSemanticSegmentation(cfg).eval()
    hf.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                        _seeded(hf.state_dict(), 4, 0.3).items()})
    hf.save_pretrained(root, safe_serialization=True)
    with open(os.path.join(root, "preprocessor_config.json"), "w") as fh:
        json.dump({**chip_smoke.SEGFORMER_PREPROCESSOR, "size": 64}, fh)
    return root


SWIN_THIN = dict(img_size=64, patch_size=4, embed_dim=16, depths=(1, 2, 2, 1),
                 num_heads=(2, 2, 4, 4), window=4, pretrained_windows=(2, 2, 2, 2))


def _swin_config():
    from ctrl_adapter_tpu_torch.conditions.swin2 import SwinV2Config

    return SwinV2Config(img_size=64, patch_size=4, embed_dim=16, depths=(1, 2, 2, 1),
                        num_heads=(2, 2, 4, 4), window_size=4,
                        pretrained_window_sizes=(2, 2, 2, 2))


@pytest.fixture(scope="module")
def midas_pt(tmp_path_factory):
    """A thin MiDaS ``.pt`` (``torch_mirrors.DPTSwinT``'s names and buffers),
    numpy-seeded."""
    path = str(tmp_path_factory.mktemp("midas") / "dpt_swin2_thin.pt")
    mirror = DPTSwinT(features=256, **SWIN_THIN)  # the classes build MiDaS's 256
    torch.save({k: torch.from_numpy(v) for k, v in
                _seeded(mirror.state_dict(), 5, 0.2).items()}, path)
    return path


@pytest.fixture(scope="module")
def jax_extractors(dpt_dir, segformer_dir, midas_pt):
    """The JAX package's estimators on the same checkpoints (one jit each)."""
    from ctrl_adapter_tpu.conditions.dpt_swin import DepthDPTSwin
    from ctrl_adapter_tpu.conditions.extractors import DepthDPT, SegmentationSegformer
    from ctrl_adapter_tpu.conditions.swin2 import SwinV2Config

    cfg = _swin_config()
    return {"dpt": DepthDPT(dpt_dir), "segformer": SegmentationSegformer(segformer_dir),
            "swin": DepthDPTSwin(midas_pt, config=SwinV2Config(**vars(cfg)))}


@pytest.fixture(scope="module")
def port_extractors(dpt_dir, segformer_dir, midas_pt):
    from ctrl_adapter_tpu_torch.conditions.dpt_swin import DepthDPTSwin

    return {"dpt": tex.DepthDPT(dpt_dir), "segformer": tex.SegmentationSegformer(segformer_dir),
            "swin": DepthDPTSwin(midas_pt, config=_swin_config())}


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_dpt_matches_flax(jax_extractors, port_extractors):
    """At the native 4x4 grid (through the JAX class's own jitted apply and
    input shape) and at 6x5 (the position embeddings resized)."""
    from ctrl_adapter_tpu.conditions.dpt import convert_dpt_state_dict

    j, t = jax_extractors["dpt"], port_extractors["dpt"]
    x = np.random.default_rng(6).standard_normal((3, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = t.model(torch.from_numpy(x)).numpy()
    want = np.asarray(j._apply(j.params, jnp.asarray(x.transpose(0, 2, 3, 1))))
    assert got.shape == want.shape == (3, 64, 64)
    assert _rel_err(got, want) < 1e-4
    x = np.random.default_rng(7).standard_normal((1, 3, 48, 40)).astype(np.float32)
    with torch.no_grad():
        got = t.model(torch.from_numpy(x)).numpy()
    params = {"params": convert_dpt_state_dict(
        {k: v.numpy() for k, v in t.model.state_dict().items()})}
    want = np.asarray(j.model.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1))))
    assert got.shape == want.shape
    assert _rel_err(got, want) < 1e-4


def test_segformer_matches_flax(jax_extractors, port_extractors):
    j, t = jax_extractors["segformer"], port_extractors["segformer"]
    x = np.random.default_rng(8).standard_normal((3, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = t.model(torch.from_numpy(x)).numpy()
    want = np.asarray(j._apply(j.params, jnp.asarray(x.transpose(0, 2, 3, 1))))
    want = want.transpose(0, 3, 1, 2)
    assert got.shape == want.shape == (3, 9, 16, 16)
    assert _rel_err(got, want) < 1e-4
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_swin2_backbone_matches_flax(port_extractors):
    from ctrl_adapter_tpu.conditions.swin2 import SwinV2Backbone, SwinV2Config
    from ctrl_adapter_tpu.convert.torch_to_jax import convert_state_dict

    backbone = port_extractors["swin"].model.pretrained.model
    x = np.random.default_rng(9).standard_normal((2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = [f.numpy() for f in backbone(torch.from_numpy(x))]
    params = {"params": convert_state_dict(
        {k: v.numpy() for k, v in backbone.state_dict().items()})}
    want = jax.jit(SwinV2Backbone(config=SwinV2Config(**vars(_swin_config()))).apply)(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        assert _rel_err(g, w) < 5e-4, f"stage {i}"


def test_dpt_swin_matches_flax(jax_extractors, port_extractors):
    j, t = jax_extractors["swin"], port_extractors["swin"]
    x = np.random.default_rng(10).standard_normal((3, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = t.model(torch.from_numpy(x)).numpy()
    want = np.asarray(j._fwd(j.params, jnp.asarray(x.transpose(0, 2, 3, 1))))
    assert got.shape == want.shape == (3, 64, 64)
    assert _rel_err(got, want) < 5e-4


def test_midas_loader_drops_buffers_and_refuses_other_files(midas_pt, tmp_path):
    from ctrl_adapter_tpu_torch.conditions.dpt_swin import midas_state_dict

    raw = torch.load(midas_pt, weights_only=True)
    kept = midas_state_dict(raw)
    assert len(kept) < len(raw) and not any("relative_" in k or "attn_mask" in k for k in kept)
    assert midas_state_dict({"model": raw}).keys() == kept.keys()
    with pytest.raises(KeyError, match="MiDaS"):
        midas_state_dict({"scratch.layer1_rn.weight": raw["scratch.layer1_rn.weight"]})


@pytest.mark.parametrize("name", ["dpt", "swin", "segformer"])
def test_extractors_match_jax_end_to_end(name, jax_extractors, port_extractors):
    """uint8 maps at the frames' size (two sizes: the batch and one frame
    alone), within one step of the JAX class's (a PIL image for
    ``DepthDPTSwin``)."""
    j, t = jax_extractors[name], port_extractors[name]
    imgs = _frames(3, 40, 56, 11)
    if name == "swin":  # the JAX class jits one batch size: the network test's
        imgs = _frames(3, 64, 72, 11)
    got, want = t(imgs), [np.asarray(m) for m in j(imgs)]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (*imgs[0].shape[:2], 3) and g.dtype == np.uint8
        assert np.abs(g.astype(int) - w).max() <= 1
    if name != "segformer":  # depth spans the gray range
        assert got[0].min() == 0 and got[0].max() == 255


# -------------------------------------------------------------- canny, shuffle
def test_canny_matches_cv2():
    import cv2

    imgs = _frames(4, 96, 80, 12) + [np.random.default_rng(13).integers(
        0, 256, (40, 48, 3), dtype=np.uint8)]
    got = tex.canny_edges(torch.from_numpy(np.stack(imgs[:4]))).numpy()
    got = list(got) + [tex.extract_canny(imgs[4])[..., 0]]
    for g, im in zip(got, imgs):
        want = cv2.Canny(im, 100, 200)
        assert want.any() and (want == 0).any()
        assert (g == want).mean() >= 0.999
        np.testing.assert_array_equal(g, want)  # bit for bit on these frames


def test_shuffle_matches_jax():
    from ctrl_adapter_tpu.conditions.extractors import extract_shuffle as jshuffle

    for i, im in enumerate(_frames(2, 96, 96, 14) + chip_smoke.smooth_frames(
            np.random.default_rng(15), 1, 300)[:1]):
        got, want = tex.extract_shuffle(im, seed=i), jshuffle(im, seed=i)
        diff = np.abs(got.astype(int) - want)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert (diff <= 1).mean() >= 0.99 and diff.max() <= 8


def test_condition_extractor_picks_and_refuses(dpt_dir, midas_pt, segformer_dir, tmp_path,
                                               monkeypatch):
    from ctrl_adapter_tpu_torch.conditions.dpt_swin import DepthDPTSwin

    def swin(path, device):
        return DepthDPTSwin(path, config=_swin_config(), device=device)

    monkeypatch.setattr(tex, "DepthDPTSwin", swin)
    ex = tex.ConditionExtractor({"depth": midas_pt, "segmentation": segformer_dir},
                                device="cpu")
    imgs = _frames(2, 40, 48, 16)
    for ctype in ("depth", "segmentation", "canny", "shuffle"):
        maps = ex.extract(ctype, imgs)
        assert [m.shape for m in maps] == [(40, 48, 3)] * 2
    assert isinstance(ex._estimators["depth"], DepthDPTSwin)
    folder = tex.ConditionExtractor({"depth": dpt_dir}, device="cpu")
    folder.add_estimator("depth")
    assert isinstance(folder._estimators["depth"], tex.DepthDPT)
    # the defaults are folders relative to the working directory; no fallback
    monkeypatch.chdir(tmp_path)
    for ctype, default in tex.DEFAULT_PATHS.items():
        with pytest.raises(RuntimeError, match="no transformers fallback") as err:
            tex.ConditionExtractor(device="cpu").add_estimator(ctype)
        assert default in str(err.value)
    for ctype in ("normal", "softedge", "lineart", "openpose", "scribble"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            ex.extract(ctype, imgs)
    with pytest.raises(ValueError, match="unknown control type"):
        tex.check_control_types(["depth", "sketch"])
    assert set(tex.MULTI_CONDITION_EXPERT_ORDER) < set(tex.CONTROL_TYPES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tex.ConditionExtractor()


def test_depth_correlation_matches_jax(port_extractors):
    """``evaluate_video`` with a depth extractor (both packages given the
    port's ``DepthDPT``), and without one: None with the reason."""
    from ctrl_adapter_tpu.evaluation import metrics as jm
    from ctrl_adapter_tpu_torch.evaluation import metrics as tm

    rng = np.random.default_rng(17)
    video = rng.uniform(0, 1, (2, 40, 48, 3)).astype(np.float32)
    cond = np.stack(port_extractors["dpt"](_frames(2, 40, 48, 18)))
    ex = port_extractors["dpt"]
    got = tm.evaluate_video(video, cond, "depth", depth_extractor=ex)
    want = jm.evaluate_video(video, cond, "depth", depth_extractor=ex)
    assert got == want and got["depth_control_correlation"] is not None
    none = tm.evaluate_video(video, cond, "depth")
    assert none["depth_control_correlation"] is None and none["skipped"]
    edges = tm.evaluate_video(video, cond, "canny")
    assert edges == jm.evaluate_video(video, cond, "canny")
