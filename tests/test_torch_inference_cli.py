"""``inference_torch.py`` and the host I/O it runs on, on the CPU.

- Parsers: the port's ``add_inference_args`` and ``add_train_args`` parse to the
  JAX package's namespaces, bare and with each ``configs/*.yaml`` merged.
- Image I/O: the PNG codec reads what cv2 and imageio write, exactly, and
  imageio reads what it writes; the GIF decodes through imageio within
  ``GIF_MAX_ERROR``; the resizes match ``cv2.resize`` within one uint8 step
  (float: 1e-5), exactly at an unchanged size and for nearest;
  ``load_image`` and ``load_conditions`` equal the JAX CLI's (importing
  ``inference.py`` compiles nothing).
- Metrics: psnr, ssim, temporal consistency and the canny F1 equal JAX's.
- The CLI at thin widths (``tests/torch_cli_common.py``: its module builder
  swapped, no flag added), for SVD, I2VGen-XL with one expert and with the
  seven of a multi-condition checkpoint, and SDXL: ``--fake_weights`` writes its
  outputs, and its video equals the port's pipeline called directly with the
  same weights and generator, bit for bit; the real-weights path loads
  fabricated diffusers folders (every tensor as written); ``--evaluate``
  writes JAX's ``evaluate_video`` of the same arrays; ``--lora`` folds what
  JAX's ``apply_lora`` folds.
- At full width on the ``meta`` device, the CLI's SVD towers have the names
  and shapes of the JAX CLI's ``jax.eval_shape`` trees.
- ``--extract_control_conditions`` (depth from a thin ``Intel/dpt-large`` in
  the working directory, and canny): the conditions the CLI used are within
  one uint8 step of the JAX CLI's ``load_conditions``; an unported type is
  refused before any tower is built, a missing depth checkpoint with its
  reason.
- The thin SVD CLI (both weight paths, and extraction of depth, canny and
  segmentation) and every port module run in a subprocess where cv2,
  imageio, PIL, yaml, safetensors, transformers, regex and JAX cannot be
  imported, as on the card's host.
"""

import argparse
import glob
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import chip_smoke
import inference_torch
from ctrl_adapter_tpu_torch.conditions import MULTI_CONDITION_EXPERT_ORDER
from ctrl_adapter_tpu_torch.convert.from_jax import _TO_TORCH, _flatten, jax_path
from ctrl_adapter_tpu_torch.convert.release import write_safetensors
from ctrl_adapter_tpu_torch.pipelines.image_latents import encode_svd_image_latent
from ctrl_adapter_tpu_torch.utils import image as timage

from . import torch_cli_common as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _jax_cli(name="inference"):
    """The JAX CLI ``{name}.py``, imported with the JAX compile-cache settings
    it sets restored afterwards; asserts that the import compiled nothing."""
    events = []
    saved = {k: getattr(jax.config, k) for k in
             ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}

    def listener(name, *_, **__):
        events.append(name)

    jax.monitoring.register_event_duration_secs_listener(listener)
    try:
        cli = importlib.import_module(name)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        jax.monitoring.unregister_event_duration_listener(listener)
    assert not [e for e in events if "compile" in e], events
    return cli


# ----------------------------------------------------------------- parsers
@pytest.mark.parametrize("yaml_file", [None] + CONFIGS,
                         ids=["defaults"] + [os.path.basename(c) for c in CONFIGS])
def test_parsers_match_jax(yaml_file):
    from ctrl_adapter_tpu import config as jconfig
    from ctrl_adapter_tpu_torch import config as tconfig

    assert len(CONFIGS) == 12
    for add in ("add_inference_args", "add_train_args"):
        spaces = []
        for mod in (jconfig, tconfig):
            parser = argparse.ArgumentParser()
            getattr(mod, add)(parser)
            spaces.append(vars(mod.merge_yaml_over_args(parser.parse_args([]), yaml_file)))
        assert spaces[0] == spaces[1], add


# ---------------------------------------------------------------- image I/O
def _pattern(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    img = chip_smoke.smooth_frames(rng, 1, max(h, w), channels=c)[0][:h, :w]
    img = img.astype(np.int32) + rng.integers(-20, 21, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "palette"])
def test_png_codec_round_trips_cv2_and_imageio(kind, tmp_path):
    import cv2
    import imageio.v2 as imageio
    from PIL import Image

    img = _pattern(37, 53, {"gray": 1, "rgb": 3, "rgba": 4, "palette": 3}[kind])
    if kind == "gray":
        img = img[..., 0]
    files = {}
    if kind == "palette":
        pil = Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=40)
        files["pil"] = str(tmp_path / "p.png")
        pil.save(files["pil"])
        img = np.asarray(pil.convert("RGB"))
    else:
        files["imageio"] = str(tmp_path / "i.png")
        imageio.imwrite(files["imageio"], img)
        files["cv2"] = str(tmp_path / "c.png")
        bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][: img.shape[2]]]
        cv2.imwrite(files["cv2"], np.ascontiguousarray(bgr))
    for writer, path in files.items():
        got = timage.read_image(path)
        assert got.shape == img.shape and (got == img).all(), writer
        assert (got == np.asarray(imageio.imread(path))).all(), writer
    if kind != "palette":
        own = timage.encode_png(img)
        assert (np.asarray(imageio.imread(io.BytesIO(own))) == img).all()
        assert (timage.decode_png(own) == img).all()


def test_gif_decodes_through_imageio(tmp_path):
    import imageio.v2 as imageio
    from PIL import Image

    frames = chip_smoke.smooth_frames(np.random.default_rng(1), 4, 40)
    frames[1] = _pattern(40, 40, 3, seed=2)  # noisy: fills the LZW table
    path = str(tmp_path / "a.gif")
    timage.save_gif(frames, path, fps=16)
    got = np.stack([f[..., :3] for f in imageio.mimread(path)])
    assert got.shape == (4, 40, 40, 3)
    assert np.abs(got.astype(int) - np.stack(frames)).max() <= timage.GIF_MAX_ERROR
    with Image.open(path) as im:
        assert im.info["loop"] == 0 and im.info["duration"] == 60  # 1000 / 16 ms, in cs
    assert (tc.frames_of(path) == got).all()


@pytest.mark.parametrize("interp,shape,out", [
    ("linear", (37, 53), (64, 64)), ("linear", (64, 64), (37, 29)),
    ("cubic", (40, 60), (80, 100)), ("cubic", (48, 48), (512, 512)),
    ("area", (40, 60), (20, 30)), ("area", (600, 800), (512, 683)),
    ("nearest", (64, 48), (37, 129)), ("nearest", (30, 45), (512, 768))])
def test_resizes_match_cv2(interp, shape, out):
    import cv2

    flag = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA,
            "nearest": cv2.INTER_NEAREST}[interp]
    img = _pattern(*shape, 3)
    got = timage.resize(img, out, interp)
    want = cv2.resize(img, out[::-1], interpolation=flag)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= (0 if interp == "nearest" else 1)
    unit = img.astype(np.float32) / 255
    np.testing.assert_allclose(timage.resize(unit, out, interp),
                               cv2.resize(unit, out[::-1], interpolation=flag), atol=1e-5)
    assert (timage.resize(img, shape, interp) == img).all()


def test_load_image_and_conditions_match_jax_cli(tmp_path):
    """One sample at 512^2 (the crop-and-resize is the identity: equal) and one
    at 48^2 (cubic upscale: within one uint8 step)."""
    inference = _jax_cli()
    from ctrl_adapter_tpu.utils.image import load_image as j_load_image

    root = str(tmp_path)
    chip_smoke.write_cli_fixture(root, 3, 512, ["depth", "canny"], seed=1, sample="s0")
    chip_smoke.write_cli_fixture(root, 3, 48, ["depth", "canny"], seed=2, sample="s1")
    args = argparse.Namespace(control_types=["depth", "canny"], extract_control_conditions=False)
    for sample, tol in (("s0", 0), ("s1", 1)):
        frame_dir = os.path.join(root, "raw_input", sample)
        paths = sorted(os.path.join(frame_dir, f) for f in os.listdir(frame_dir))
        got = [timage.load_image(p) for p in paths]
        want = [j_load_image(p) for p in paths]
        assert all(g.shape == w.shape == (512, 512, 3) for g, w in zip(got, want))
        assert max(np.abs(g.astype(int) - w).max() for g, w in zip(got, want)) <= tol
        conds = inference_torch.load_conditions(args, root, sample, got)
        jconds = inference.load_conditions(args, root, sample, want)
        assert conds.shape == jconds.shape == (2, 3, 512, 512, 3)
        np.testing.assert_allclose(conds, jconds, atol=tol / 255 + 1e-7)


def test_metrics_match_jax():
    from ctrl_adapter_tpu.evaluation import metrics as jm
    from ctrl_adapter_tpu_torch.evaluation import metrics as tm

    rng = np.random.default_rng(3)
    a, b = (rng.uniform(0, 1, (3, 24, 32, 3)).astype(np.float32) for _ in range(2))
    edges = (rng.uniform(0, 1, (24, 32, 3)) > 0.8).astype(np.uint8) * 255
    assert tm.psnr(a, b) == jm.psnr(a, b) and tm.psnr(a, a) == jm.psnr(a, a)
    assert tm.ssim(a, b) == jm.ssim(a, b)
    assert tm.temporal_consistency(a) == jm.temporal_consistency(a)
    img = timage.unit_to_uint8(a[0])
    assert tm.canny_control_f1(img, edges) == jm.canny_control_f1(img, edges)


# -------------------------------------------------------------------- the CLI
CASES = {"svd": ("svd", ["depth"]), "i2vgenxl": ("i2vgenxl", ["canny"]),
         "i2vgenxl-multi": ("i2vgenxl", list(MULTI_CONDITION_EXPERT_ORDER)),
         "sdxl": ("sdxl", ["depth"])}


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return tc.write_fixture(str(tmp_path_factory.mktemp("fixture")), MULTI_CONDITION_EXPERT_ORDER)


@pytest.fixture
def thin_cli(monkeypatch):
    monkeypatch.setattr(inference_torch, "build_modules", tc.thin_build_modules)
    return inference_torch


def _direct_video(model, types, fixture, pipe, seed=3):
    """The video of the port's pipeline called directly, as the CLI calls it
    with --fake_weights: pseudo embeddings from numpy's generator of the seed,
    zero image latent, latents from a torch generator of the seed."""
    size, f = tc.SIZE[model], tc.FRAMES
    frame_dir = os.path.join(fixture, "raw_input", "s0")
    frames = [timage.load_image(os.path.join(frame_dir, n)) for n in sorted(os.listdir(frame_dir))]
    args = argparse.Namespace(control_types=types, extract_control_conditions=False)
    conds = inference_torch.load_conditions(args, fixture, "s0", frames[: 1 if model == "sdxl"
                                                                         else f])
    cond = 64
    conds = np.stack([np.stack([timage.resize(fr, (cond, cond)) for fr in c]) for c in conds])
    rng = np.random.default_rng(seed)

    def text(dim):
        return torch.from_numpy(rng.standard_normal((2, 77, dim)).astype(np.float32) * 0.1)

    gen = torch.Generator().manual_seed(seed)
    common = dict(height=size, width=size, num_inference_steps=2, guess_mode=False,
                  control_latent_size=8, generator=gen)
    if model == "sdxl":
        prompt = text(2048)
        return pipe.generate(prompt, torch.ones((2, 1280)) * 0.1, text(768),
                             torch.from_numpy(conds[0]), guidance_scale=9.0,
                             controlnet_conditioning_scale=1.0, control_guidance_start=0.0,
                             control_guidance_end=0.8, **common).numpy()[None]
    if model == "i2vgenxl":
        prompt = text(1024)
        return pipe.generate(prompt, text(768), torch.ones((1, 1, 1024)) * 0.1,
                             torch.zeros((1, size // 8, size // 8, 4)),
                             torch.from_numpy(conds), num_frames=f, guidance_scale=9.0,
                             **common).numpy()
    return pipe.generate(torch.ones((1, 1, 1024)) * 0.1, torch.zeros((1, size // 8, size // 8, 4)),
                         text(768), torch.from_numpy(conds[0]), num_frames=f, skip_conv_in=False,
                         **common).numpy()


def _no_depth_midas(monkeypatch):
    """JAX's ``evaluate_video`` would build a DPT from the hub for depth; here
    it finds no local checkpoint, as the port reports it."""
    from ctrl_adapter_tpu.conditions import extractors

    def refuse(*_, **__):
        raise OSError("no local DPT checkpoint")

    monkeypatch.setattr(extractors, "DepthMidas", refuse)


@pytest.mark.parametrize("case", list(CASES))
def test_cli_fake_weights_equals_the_pipeline(case, fixture_dir, thin_cli, tmp_path,
                                              monkeypatch):
    from ctrl_adapter_tpu.evaluation.metrics import evaluate_video

    model, types = CASES[case]
    run = thin_cli.main(tc.cli_argv(model, types, fixture_dir, str(tmp_path), "--fake_weights",
                                    "--evaluate", "True"), device="cpu")
    video = run.videos["s0"]
    f = 1 if model == "sdxl" else tc.FRAMES
    assert video.shape == (1, f, tc.SIZE[model], tc.SIZE[model], 3)
    out = os.path.join(run.out_root, "s0")
    if model == "sdxl":
        assert timage.read_image(os.path.join(out, "output.png")).shape == video.shape[2:]
    else:
        assert tc.frames_of(os.path.join(out, "output.gif")).shape == (f, 64, 64, 3)
        assert tc.frames_of(os.path.join(out, "output_concat.gif")).shape == (f, 64, 128, 3)

    pipe = tc.thin_build_modules(argparse.Namespace(model_name=model, control_types=types),
                                 "cpu")
    inference_torch.fabricate_params(pipe)
    for name, module in inference_torch.towers(pipe).items():
        got = inference_torch.towers(run.pipe)[name].state_dict()
        assert all(torch.equal(got[k], v) for k, v in module.state_dict().items()), name
    np.testing.assert_array_equal(video, _direct_video(model, types, fixture_dir, pipe))

    _no_depth_midas(monkeypatch)
    with open(os.path.join(out, "metrics.json")) as fh:
        metrics = json.load(fh)
    conds = inference_torch.load_conditions(
        argparse.Namespace(control_types=types[:1], extract_control_conditions=False),
        fixture_dir, "s0", [None] * f)[0]
    cond_uint8 = np.stack([timage.resize(timage.unit_to_uint8(c), video.shape[2:4], "nearest")
                           for c in conds])
    want = evaluate_video(video[0], cond_uint8, control_type=types[0])
    assert metrics == json.loads(json.dumps({"sample": "s0", "control_type": types[0], **want}))


@pytest.mark.parametrize("case", list(CASES))
def test_cli_loads_diffusers_folders(case, fixture_dir, thin_cli, tmp_path):
    model, types = CASES[case]
    src = tc.thin_build_modules(argparse.Namespace(model_name=model, control_types=types), "cpu")
    flags = tc.write_thin_release(src, model, str(tmp_path / "release"))
    run = thin_cli.main(tc.cli_argv(model, types, fixture_dir, str(tmp_path / "out"), *flags),
                        device="cpu")
    for name, module in inference_torch.towers(src).items():
        got = inference_torch.towers(run.pipe)[name].state_dict()
        assert set(got) == set(module.state_dict())
        assert all(torch.equal(got[k], v) for k, v in module.state_dict().items()), name
    video = run.videos["s0"]
    assert np.isfinite(video).all() and video.min() >= 0 and video.max() <= 1
    assert set(run.encoders) == {"svd": {"controlnet", "image"},
                                 "i2vgenxl": {"controlnet", "text", "image"},
                                 "sdxl": {"controlnet", "text", "text_2"}}[model]
    if model != "svd":
        return
    # SVD with the encoders and the noise-augmented image latent, called directly
    frame_dir = os.path.join(fixture_dir, "raw_input", "s0")
    frames = [timage.load_image(os.path.join(frame_dir, n)) for n in sorted(os.listdir(frame_dir))]
    args = argparse.Namespace(control_types=types, extract_control_conditions=False)
    conds = inference_torch.load_conditions(args, fixture_dir, "s0", frames)
    conds = np.stack([timage.resize(fr, (64, 64)) for fr in conds[0]])
    image = run.encoders["image"]([frames[0]], antialiased=True)
    cn = run.encoders["controlnet"]([chip_smoke.CLI_PROMPT], [""])
    unit = torch.from_numpy(timage.image_to_unit(timage.resize(frames[0], (64, 64))))
    latent = encode_svd_image_latent(run.pipe.vae, unit, generator=torch.Generator().manual_seed(4))
    want = run.pipe.generate(image, latent, cn, torch.from_numpy(conds), height=64, width=64,
                             num_frames=tc.FRAMES, num_inference_steps=2, control_latent_size=8,
                             skip_conv_in=False, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(video, want.numpy())


def test_cli_lora_folds_like_jax(fixture_dir, thin_cli, tmp_path):
    """A kohya LoRA (a linear and a conv of the UNet) and a peft one (a linear),
    at scale 0.7: the CLI's UNet weights equal JAX's ``apply_lora`` on the same
    fabricated tree (fp32; 1e-6 for the two libraries' rank-4 products)."""
    from ctrl_adapter_tpu.convert.lora import apply_lora as j_apply_lora
    from ctrl_adapter_tpu.convert.torch_to_jax import convert_state_dict

    g = torch.Generator().manual_seed(8)
    pipe = tc.thin_build_modules(argparse.Namespace(model_name="svd", control_types=["depth"]),
                                 "cpu")
    inference_torch.fabricate_params(pipe)
    state = pipe.unet.state_dict()
    weights = [k[: -len(".weight")] for k in state if k.endswith(".weight")]
    linear = next(k for k in weights if k.endswith("attn1.to_q"))
    conv = next(k for k in weights
                if k.startswith("down_blocks.1.") and state[k + ".weight"].dim() == 4)
    peft = next(k for k in weights if k.startswith("up_blocks.1.") and k.endswith("proj_out"))
    targets = {"lora_unet_" + linear.replace(".", "_"): (linear, "kohya"),
               "lora_unet_" + conv.replace(".", "_"): (conv, "kohya"),
               "unet." + peft: (peft, "peft")}
    lora = {}
    for key, (name, kind) in targets.items():
        w = state[name + ".weight"]
        down_shape = (4, *w.shape[1:])
        up_shape = (w.shape[0], 4) + ((1, 1) if w.dim() == 4 else ())
        down, up = (torch.randn(s, generator=g) * 0.1 for s in (down_shape, up_shape))
        if kind == "peft":
            lora.update({f"{key}.lora_A.weight": down, f"{key}.lora_B.weight": up})
        else:
            lora.update({f"{key}.lora_down.weight": down, f"{key}.lora_up.weight": up,
                         f"{key}.alpha": torch.tensor(2.0)})
    path = str(tmp_path / "lora.safetensors")
    write_safetensors(lora, path)
    run = thin_cli.main(tc.cli_argv("svd", ["depth"], fixture_dir, str(tmp_path / "out"),
                                    "--fake_weights", "--lora", path, "--lora_scale", "0.7"),
                        device="cpu")
    tree = convert_state_dict({k: v.numpy() for k, v in state.items()})
    assert j_apply_lora(tree, {k: v.numpy() for k, v in lora.items()}, scale=0.7) == 3
    flat = _flatten(tree)
    got = run.pipe.unet.state_dict()
    changed = 0
    for name, t in got.items():
        want = flat[jax_path(name, t.dim())]
        if jax_path(name, t.dim())[-1] == "kernel":
            want = want.transpose(_TO_TORCH[want.ndim])
        np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=1e-6, err_msg=name)
        changed += not torch.equal(t, state[name])
    assert changed == 3


def test_cli_needs_a_card_and_pre_extracted_conditions(fixture_dir, thin_cli, tmp_path,
                                                       monkeypatch):
    """No card: refused. Extraction of a type whose network needs a
    checkpoint path (the serving CLI passes none, as the JAX CLI): a
    ``RuntimeError`` naming ``CTRL_ADAPTER_ANNOTATORS`` before any tower is
    built. Depth extraction with no ``Intel/dpt-large`` folder in the
    working directory: refused, naming the missing fallback."""
    argv = tc.cli_argv("svd", ["depth"], fixture_dir, str(tmp_path), "--fake_weights")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thin_cli.main(argv)
    built = []
    monkeypatch.setattr(thin_cli, "build_modules",
                        lambda *a, **k: built.append(1) or tc.thin_build_modules(*a, **k))
    for extra in (["--extract_control_conditions", "True"], []):  # scribble has no folder
        with pytest.raises(RuntimeError, match="CTRL_ADAPTER_ANNOTATORS"):
            thin_cli.main(tc.cli_argv("svd", ["scribble"], fixture_dir, str(tmp_path),
                                      "--fake_weights", *extra), device="cpu")
    assert not built
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no transformers fallback"):
        thin_cli.main(argv + ["--extract_control_conditions", "True"], device="cpu")


@pytest.mark.parametrize("ctype", ["depth", "canny"])
def test_cli_extracts_conditions_like_jax(ctype, fixture_dir, thin_cli, tmp_path, monkeypatch):
    """``--extract_control_conditions`` from a working directory holding a thin
    ``Intel/dpt-large``: the conditions the CLI generated with are within one
    uint8 step of the JAX CLI's ``load_conditions`` on the same frames."""
    monkeypatch.chdir(tmp_path)
    tc.write_annotators(str(tmp_path))
    seen = []

    def recorded(*a, **k):
        seen.append((a[3], load(*a, **k)))
        return seen[-1][1]

    load = inference_torch.load_conditions
    monkeypatch.setattr(thin_cli, "load_conditions", recorded)
    run = thin_cli.main(tc.cli_argv("svd", [ctype], fixture_dir, str(tmp_path / "out"),
                                    "--fake_weights", "--extract_control_conditions", "True"),
                        device="cpu")
    assert len(seen) == 1 and run.videos["s0"].shape == (1, tc.FRAMES, 64, 64, 3)
    frames, conds = seen[0]
    jax_cli = _jax_cli()
    args = argparse.Namespace(control_types=[ctype], extract_control_conditions=True)
    want = jax_cli.load_conditions(args, fixture_dir, "s0", frames)
    assert conds.shape == want.shape == (1, tc.FRAMES, 512, 512, 3)
    assert np.abs(conds - want).max() <= 1 / 255 + 1e-6
    pre = inference_torch.load_conditions(
        argparse.Namespace(control_types=[ctype], extract_control_conditions=False),
        fixture_dir, "s0", frames)
    assert not np.array_equal(pre, conds)  # the fixture's own folder was not read


def test_cli_svd_towers_match_jax_trees():
    """``inference_torch.build_modules`` (SVD, full width, ``meta`` device) against
    the JAX CLI's modules under ``jax.eval_shape``: the same parameter names
    (through ``jax_path``) and shapes (kernels transposed)."""
    import jax.numpy as jnp

    inference = _jax_cli()
    args = argparse.Namespace(model_name="svd", control_types=["depth"])
    pipe = inference_torch.build_modules(args, "meta")
    jpipe = inference.build_modules(args)
    f, cls = 2, 8
    cn_args = (jnp.ones((2 * f, cls, cls, 4)), jnp.ones((2 * f,)), jnp.ones((2 * f, 77, 768)),
               jnp.ones((2 * f, cls * 8, cls * 8, 3)))

    def shapes(module, *a):
        return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *a))

    cn_tree = shapes(jpipe.controlnet, *cn_args)
    downs, mid = jax.eval_shape(lambda p: jpipe.controlnet.apply(p, *cn_args), cn_tree)
    trees = {
        "unet": shapes(jpipe.unet, jnp.ones((2, f, cls, cls, 8)), jnp.ones((2,)),
                       jnp.ones((2, 1, 1024)), jnp.ones((2, 3))),
        "controlnet": cn_tree,
        "adapter": shapes(jpipe.adapter, [jnp.zeros(s.shape) for s in downs],
                          jnp.zeros(mid.shape), f, jnp.ones((2 * f,)), jnp.ones((1, 1, 1024))),
        "vae": shapes(jpipe.vae, jnp.ones((1, 64, 64, 3))),
    }
    for name, tree in trees.items():
        want = {k: tuple(v.shape) for k, v in _flatten_shapes(tree["params"]).items()}
        got = {}
        for pname, p in getattr(pipe, name).named_parameters():
            assert p.device.type == "meta" and p.dtype == torch.bfloat16
            shape = tuple(p.shape)
            if jax_path(pname, p.dim())[-1] == "kernel":
                shape = tuple(shape[i] for i in np.argsort(_TO_TORCH[p.dim()]))
            got[jax_path(pname, p.dim())] = shape
        assert got == want, name


def _flatten_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


BLOCKED = ("cv2", "imageio", "PIL", "yaml", "safetensors", "transformers", "regex", "jax",
           "flax", "optax", "orbax", "ctrl_adapter_tpu")

_SUBPROCESS = """
import importlib, importlib.abc, os, pkgutil, sys, tempfile
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
sys.path[:0] = [{repo!r}, {tests!r}]
import argparse
import numpy as np
import torch
import ctrl_adapter_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import inference_torch
import torch_cli_common as tc
from ctrl_adapter_tpu_torch.utils import image as timage
inference_torch.build_modules = tc.thin_build_modules
root = tempfile.mkdtemp(dir={tmp!r})
fx = tc.write_fixture(os.path.join(root, "fx"), ["depth"])
fake = inference_torch.main(tc.cli_argv("svd", ["depth"], fx, os.path.join(root, "a"),
                                        "--fake_weights"), device="cpu")
src = tc.thin_build_modules(argparse.Namespace(model_name="svd", control_types=["depth"]), "cpu")
flags = tc.write_thin_release(src, "svd", os.path.join(root, "release"))
real = inference_torch.main(tc.cli_argv("svd", ["depth"], fx, os.path.join(root, "b"), *flags),
                            device="cpu")
for run in (fake, real):
    assert tc.frames_of(os.path.join(run.out_root, "s0", "output.gif")).shape == (3, 64, 64, 3)
os.chdir(root)
tc.write_annotators(root)
for ctype in ("depth", "canny", "segmentation"):
    run = inference_torch.main(tc.cli_argv("svd", [ctype], fx, os.path.join(root, ctype),
                                           "--fake_weights", "--extract_control_conditions",
                                           "True"), device="cpu")
    assert run.videos["s0"].shape == (1, 3, 64, 64, 3)
jpg = os.path.join(root, "x.jpg")
open(jpg, "wb").write(b"\\xff\\xd8\\xff")
try:
    timage.read_image(jpg)
    raise AssertionError("a JPEG was read without cv2")
except RuntimeError as e:
    assert "cv2" in str(e)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok", len(names))
"""


def test_cli_runs_without_host_packages(tmp_path):
    code = _SUBPROCESS.format(blocked=BLOCKED, repo=REPO, tests=os.path.join(REPO, "tests"),
                              tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("ok")
