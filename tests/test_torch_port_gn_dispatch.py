"""Which GroupNorms run kernel K1: the port's rule against the JAX package's.

JAX's ``group_norm_silu`` takes its Pallas kernel by ``use_pallas`` (None:
``CTRL_ADAPTER_FUSED_GN=1``; "prefer": always; False: never), in each case
only where ``_eligible`` holds (``ctrl_adapter_tpu/ops/group_norm.py:205-218,
244-246``). The port's ``GroupNorm`` flag is the same three-way switch, read
per call, with ``group_norm.eligible``.

- Every norm of the SVD slice at full width (the adapter, UNet, ControlNet and
  temporal VAE, bf16, run once on the ``meta`` device), with and without the
  switch: the port's choice against JAX's ``group_norm_silu`` deciding on a
  ``jax.ShapeDtypeStruct`` of the same (NHWC) shape with the same flag, its
  device test patched to "TPU" and its kernel replaced by a spy. The adapter's
  norms carry "prefer" and all others None, as the JAX modules pass them.
- The same at every norm of the I2VGen-XL path (adapter, I2VGen-XL UNet,
  ControlNet, 2D VAE) at b*f = 32, and of the SDXL path (the SDXL adapter,
  UNet, ControlNet and VAE) at batch 2.
- Each flag value under the switch, at shapes the rule takes and refuses.
- The three paths again with fp32 towers (``--mixed_precision no``): K1 takes
  fp32 input, and JAX's rule decides at itemsize 4 (a float32
  ``ShapeDtypeStruct``), so a norm's 4 * S * C * 4 bytes count against the
  12 MiB budget.
"""

from collections import Counter

import pytest
import torch

import jax
import jax.numpy as jnp

import ctrl_adapter_tpu.ops.backend as jbackend
from ctrl_adapter_tpu.ops import group_norm as jgn
from ctrl_adapter_tpu_torch.nn.resnet import GroupNorm
from ctrl_adapter_tpu_torch.ops import group_norm as gn

META, BF = torch.device("meta"), torch.bfloat16


def _jax_takes(flag, shape, groups=32, dtype=jnp.bfloat16):
    """Whether JAX's group_norm_silu, on a TPU, would launch its kernel for an
    (N, C, *spatial) tensor of ``dtype`` with this ``use_pallas`` flag."""
    calls = []

    def spy(x, *args, **kwargs):
        calls.append(1)
        return jnp.zeros(x.shape, x.dtype)

    c = shape[1]
    sds = jax.ShapeDtypeStruct((shape[0], *shape[2:], c), dtype)
    orig = jgn._pallas_group_norm_silu
    jgn._pallas_group_norm_silu = spy
    try:
        jax.eval_shape(lambda x, s, b: jgn.group_norm_silu(x, s, b, groups, 1e-6, True, flag),
                       sds, jax.ShapeDtypeStruct((c,), jnp.float32),
                       jax.ShapeDtypeStruct((c,), jnp.float32))
    finally:
        jgn._pallas_group_norm_silu = orig
    return bool(calls)


@pytest.fixture
def jax_on_tpu(monkeypatch):
    monkeypatch.setattr(jbackend, "is_tpu_backend", lambda: True)
    return monkeypatch


def _set_env(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("CTRL_ADAPTER_FUSED_GN", raising=False)
    else:
        monkeypatch.setenv("CTRL_ADAPTER_FUSED_GN", value)


def _record_norms(monkeypatch):
    """Patch ``GroupNorm.forward`` to record (tower, flag, shape, kernel taken)
    per call; the tower is set by the caller in ``state``."""
    seen, state = [], {"tower": None, "kernel": False}
    real_forward = GroupNorm.forward

    def kernel(x, w, b, groups, eps, silu):
        state["kernel"] = True
        return gn._torch_group_norm_silu(x, w, b, groups, eps, silu)

    def forward(self, x, silu=False):
        state["kernel"] = False
        out = real_forward(self, x, silu)
        seen.append((state["tower"], self.kernel, tuple(x.shape), state["kernel"]))
        return out

    monkeypatch.setattr(GroupNorm, "forward", forward)
    return seen, state, kernel


@pytest.mark.parametrize("env", [None, "1"], ids=["default", "fused-gn"])
def test_k1_choice_matches_jax_at_every_norm_of_the_slice(jax_on_tpu, env):
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
    from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel
    from ctrl_adapter_tpu_torch.models.vae import VAEConfig
    from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder

    _set_env(jax_on_tpu, env)
    seen, state, kernel = _record_norms(jax_on_tpu)
    e = lambda *s: torch.empty(*s, device=META, dtype=BF)  # noqa: E731
    with chip_smoke.plain_kernels(), torch.no_grad(), jax_on_tpu.context() as mp:
        mp.setattr(gn, "group_norm_silu", kernel)  # undone before the wrappers return
        state["tower"] = "adapter"
        adapter = ControlNetAdapter(cross_attention_dim=1024, num_blocks=1,
                                    adapter_locations=("A", "B", "C", "D", "M"),
                                    add_temporal_resnet=True, add_temporal_transformer=True,
                                    device=META, dtype=BF)
        res = [e(28, c, h, h) for c, h in chip_smoke.adapter_blocks()[:-1]]
        adapter(res, e(28, 1280, 8, 8), num_frames=14, timestep=torch.ones(2, device=META),
                encoder_hidden_states=e(2, 1, 1024))
        state["tower"] = "unet"
        UNetSpatioTemporalConditionModel(device=META, dtype=BF)(
            e(2, 14, 8, 64, 64), torch.ones(2, device=META), e(2, 1, 1024),
            torch.empty(2, 3, device=META))
        state["tower"] = "controlnet"
        ControlNetModel(device=META, dtype=BF)(e(28, 4, 64, 64), torch.ones(28, device=META),
                                               e(28, 77, 768), e(28, 3, 512, 512),
                                               skip_conv_in=True)
        state["tower"] = "vae"
        vae = AutoencoderKLTemporalDecoder(VAEConfig(), device=META, dtype=BF)
        vae.encode_moments(e(14, 3, 512, 512))
        vae.decode(e(14, 4, 64, 64), 14)

    assert {(tower, flag) for tower, flag, _, _ in seen} == {
        ("adapter", "prefer"), ("unet", None), ("controlnet", None), ("vae", None)}
    verdicts = {}
    for tower, flag, shape, taken in seen:
        key = (flag, shape)
        if key not in verdicts:
            verdicts[key] = _jax_takes(flag, shape)
        assert taken == verdicts[key], (tower, flag, shape, taken)
    per_tower = Counter(tower for tower, _, _, taken in seen if taken)
    assert per_tower["adapter"] == 47  # of its 65 norms (chip_smoke.k1_rows)
    if env is None:
        assert set(per_tower) == {"adapter"}
    else:  # the switch adds the towers' norms the rule admits; the VAE's
        # 512x512 to 64x64 maps all exceed its 12 MiB budget
        assert per_tower["unet"] and per_tower["controlnet"] and not per_tower["vae"]
    assert not all(taken for *_, taken in seen)


@pytest.mark.parametrize("env", [None, "1"], ids=["default", "fused-gn"])
def test_k1_choice_matches_jax_at_every_norm_of_the_i2vgenxl_path(jax_on_tpu, env):
    """The I2VGen-XL path at full width, b*f = 32 (16 frames, CFG): the adapter,
    the I2VGen-XL UNet (its TemporalConvLayers and TransformerTemporalModels
    norm 5-D (b, c, f, h, w) tensors), the ControlNet and the 2D VAE (the
    first-frame encode and a 2-frame decode chunk)."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
    from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet
    from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL

    _set_env(jax_on_tpu, env)
    seen, state, kernel = _record_norms(jax_on_tpu)
    f = chip_smoke.I2V_FRAMES
    e = lambda *s: torch.empty(*s, device=META, dtype=BF)  # noqa: E731
    with chip_smoke.plain_kernels(), torch.no_grad(), jax_on_tpu.context() as mp:
        mp.setattr(gn, "group_norm_silu", kernel)  # undone before the wrappers return
        state["tower"] = "adapter"
        adapter = ControlNetAdapter(cross_attention_dim=1024, num_blocks=1,
                                    adapter_locations=("A", "B", "C", "D", "M"),
                                    add_temporal_resnet=True, add_temporal_transformer=True,
                                    device=META, dtype=BF)
        res = [e(2 * f, c, h, h) for c, h in chip_smoke.adapter_blocks()[:-1]]
        adapter(res, e(2 * f, 1280, 8, 8), num_frames=f, timestep=981.0,
                encoder_hidden_states=e(2, 1, 1024))
        state["tower"] = "unet"
        I2VGenXLUNet(device=META, dtype=BF)(
            e(2, f, 4, 64, 64), 981.0, torch.full((2,), 16.0, device=META),
            e(2, f, 4, 64, 64), e(2, 1, 1024), e(2, 77, 1024))
        state["tower"] = "controlnet"
        ControlNetModel(device=META, dtype=BF)(e(2 * f, 4, 64, 64), 981.0,
                                               e(2 * f, 77, 768), e(2 * f, 3, 512, 512))
        state["tower"] = "vae"
        vae = AutoencoderKL(device=META, dtype=BF)
        vae.encode_moments(e(1, 3, 512, 512))
        vae.decode(e(2, 4, 64, 64))

    assert {(tower, flag) for tower, flag, _, _ in seen} == {
        ("adapter", "prefer"), ("unet", None), ("controlnet", None), ("vae", None)}
    assert any(len(shape) == 5 for tower, _, shape, _ in seen if tower == "unet")
    verdicts = {}
    for tower, flag, shape, taken in seen:
        key = (flag, shape)
        if key not in verdicts:
            verdicts[key] = _jax_takes(flag, shape)
        assert taken == verdicts[key], (tower, flag, shape, taken)
    per_tower = Counter(tower for tower, _, _, taken in seen if taken)
    assert per_tower["adapter"] == sum(chip_smoke.k1_rows(f).values()) == 47
    if env is None:
        assert set(per_tower) == {"adapter"}
    else:  # the towers' norms the rule admits; the VAE's maps at 64x64 and up exceed it
        assert per_tower["unet"] and per_tower["controlnet"]
    assert not all(taken for *_, taken in seen)


@pytest.mark.parametrize("env", [None, "1"], ids=["default", "fused-gn"])
def test_k1_choice_matches_jax_at_every_norm_of_the_sdxl_path(jax_on_tpu, env):
    """The SDXL path at full width, batch 2 (the CFG pair): the SDXL adapter
    (its norms before and after the x2 upsample), the SDXL UNet at 128x128
    latents, the ControlNet at 64x64 and the VAE decode at 1024x1024."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
    from ctrl_adapter_tpu_torch.models.unet_2d import SDXL_CONFIG, UNet2DConditionModel
    from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL

    _set_env(jax_on_tpu, env)
    seen, state, kernel = _record_norms(jax_on_tpu)
    e = lambda *s: torch.empty(*s, device=META, dtype=BF)  # noqa: E731
    with chip_smoke.plain_kernels(), torch.no_grad(), jax_on_tpu.context() as mp:
        mp.setattr(gn, "group_norm_silu", kernel)  # undone before the wrappers return
        state["tower"] = "adapter"
        adapter = ControlNetAdapter(backbone_model_name="sdxl", cross_attention_dim=2048,
                                    num_blocks=1, adapter_locations=("A", "B", "C"),
                                    device=META, dtype=BF)
        down, _ = adapter([e(2, c, h, h) for c, h in chip_smoke.adapter_blocks(64)[:-1]],
                          None, num_frames=1, timestep=951.0,
                          encoder_hidden_states=e(2, 77, 2048))
        state["tower"] = "unet"
        UNet2DConditionModel(SDXL_CONFIG, device=META, dtype=BF)(
            e(2, 4, 128, 128), 951.0, e(2, 77, 2048),
            {"text_embeds": e(2, 1280), "time_ids": e(2, 6)},
            down_block_additional_residuals=down)
        state["tower"] = "controlnet"
        ControlNetModel(device=META, dtype=BF)(e(2, 4, 64, 64), 951.0, e(2, 77, 768),
                                               e(2, 3, 512, 512))
        state["tower"] = "vae"
        AutoencoderKL(device=META, dtype=BF).decode(e(1, 4, 128, 128))

    assert {(tower, flag) for tower, flag, _, _ in seen} == {
        ("adapter", "prefer"), ("unet", None), ("controlnet", None), ("vae", None)}
    verdicts = {}
    for tower, flag, shape, taken in seen:
        key = (flag, shape)
        if key not in verdicts:
            verdicts[key] = _jax_takes(flag, shape)
        assert taken == verdicts[key], (tower, flag, shape, taken)
    per_tower = Counter(tower for tower, _, _, taken in seen if taken)
    assert per_tower["adapter"] == sum(chip_smoke.sdxl_k1_rows().values()) == 17
    assert sum(tower == "adapter" for tower, *_ in seen) == 27
    if env is None:
        assert set(per_tower) == {"adapter"}
    else:  # the switch adds the towers' norms the rule admits; the VAE's maps
        # at 128x128 and up exceed it
        assert per_tower["unet"] and per_tower["controlnet"]
    assert not all(taken for *_, taken in seen)


@pytest.mark.parametrize("env", [None, "1"], ids=["default", "fused-gn"])
@pytest.mark.parametrize("flag", [None, "prefer", False])
def test_group_norm_flag_matches_jax(jax_on_tpu, flag, env):
    """Each flag value under the switch: the port's GroupNorm and JAX's
    ``group_norm_silu`` take the kernel at the same shapes: (28, 320, 64, 64)
    fits the 12 MiB rule, (2, 320, 14, 64, 64) does not, and (2, 64, 2, 2) has
    fewer than 8 positions."""
    _set_env(jax_on_tpu, env)
    seen, state, kernel = _record_norms(jax_on_tpu)
    jax_on_tpu.setattr(gn, "group_norm_silu", kernel)
    shapes = ((28, 320, 64, 64), (2, 320, 14, 64, 64), (2, 64, 2, 2))
    with torch.no_grad():
        for shape in shapes:
            GroupNorm(32, shape[1], 1e-6, kernel=flag, device=META, dtype=BF)(
                torch.empty(shape, device=META, dtype=BF), silu=True)
    got = [taken for *_, taken in seen]
    assert got == [_jax_takes(flag, shape) for shape in shapes]
    assert got == [flag == "prefer" or (flag is None and env == "1"), False, False]


def test_eligible_is_the_jax_rule_on_a_grid():
    for shape in ((2, 64, 8), (2, 64, 4, 2), (2, 96, 3, 3), (2, 1280, 8, 8), (2, 1280, 14, 8, 8),
                  (2, 640, 14, 16, 16), (28, 320, 64, 64), (1, 320, 64, 80), (2, 32, 7)):
        for itemsize, jd in ((2, jnp.bfloat16), (4, jnp.float32)):
            want = jgn._eligible(jax.ShapeDtypeStruct((shape[0], *shape[2:], shape[1]), jd), 32)
            assert gn.eligible(shape, 32, itemsize) == want, (shape, itemsize)


def _check_verdicts(seen, dtype):
    verdicts = {}
    for tower, flag, shape, taken in seen:
        key = (flag, shape)
        if key not in verdicts:
            verdicts[key] = _jax_takes(flag, shape, dtype=dtype)
        assert taken == verdicts[key], (tower, flag, shape, taken)
    return Counter(tower for tower, _, _, taken in seen if taken)


@pytest.mark.parametrize("env", [None, "1"], ids=["default", "fused-gn"])
@pytest.mark.parametrize("path", ["svd", "i2vgenxl", "sdxl"])
def test_k1_choice_matches_jax_at_every_norm_under_fp32(jax_on_tpu, env, path):
    """Every norm of each path with fp32 towers: the adapter and the UNet as
    the paths above run them (the training step runs these two towers and the
    ControlNet under ``--mixed_precision no``), the port's choice against JAX's
    rule at itemsize 4. The 12 MiB budget takes half the elements it takes in
    bf16, so fewer adapter norms run K1 than the bf16 path's."""
    import chip_smoke
    from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
    from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel

    f32 = torch.float32
    _set_env(jax_on_tpu, env)
    seen, state, kernel = _record_norms(jax_on_tpu)
    e = lambda *s: torch.empty(*s, device=META, dtype=f32)  # noqa: E731
    with chip_smoke.plain_kernels(), torch.no_grad(), jax_on_tpu.context() as mp:
        mp.setattr(gn, "group_norm_silu", kernel)
        state["tower"] = "adapter"
        if path == "sdxl":
            from ctrl_adapter_tpu_torch.models.unet_2d import SDXL_CONFIG, UNet2DConditionModel

            adapter = ControlNetAdapter(backbone_model_name="sdxl", cross_attention_dim=2048,
                                        num_blocks=1, adapter_locations=("A", "B", "C"),
                                        device=META, dtype=f32)
            down, _ = adapter([e(1, c, h, h) for c, h in chip_smoke.adapter_blocks(64)[:-1]],
                              None, num_frames=1, timestep=951.0,
                              encoder_hidden_states=e(1, 77, 2048))
            state["tower"] = "unet"
            UNet2DConditionModel(SDXL_CONFIG, device=META, dtype=f32)(
                e(1, 4, 128, 128), 951.0, e(1, 77, 2048),
                {"text_embeds": e(1, 1280), "time_ids": e(1, 6)},
                down_block_additional_residuals=down)
            cn_batch, cn_t = 1, 951.0
        else:
            f = chip_smoke.FRAMES if path == "svd" else chip_smoke.I2V_FRAMES
            adapter = ControlNetAdapter(cross_attention_dim=1024, num_blocks=1,
                                        adapter_locations=("A", "B", "C", "D", "M"),
                                        add_temporal_resnet=True, add_temporal_transformer=True,
                                        device=META, dtype=f32)
            res = [e(f, c, h, h) for c, h in chip_smoke.adapter_blocks()[:-1]]
            adapter(res, e(f, 1280, 8, 8), num_frames=f, timestep=torch.ones(1, device=META),
                    encoder_hidden_states=e(1, 1, 1024))
            state["tower"] = "unet"
            if path == "svd":
                from ctrl_adapter_tpu_torch.models.unet_svd import (
                    UNetSpatioTemporalConditionModel)

                UNetSpatioTemporalConditionModel(device=META, dtype=f32)(
                    e(1, f, 8, 64, 64), torch.ones(1, device=META), e(1, 1, 1024),
                    torch.empty(1, 3, device=META))
            else:
                from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet

                I2VGenXLUNet(device=META, dtype=f32)(
                    e(1, f, 4, 64, 64), 981.0, torch.full((1,), 16.0, device=META),
                    e(1, f, 4, 64, 64), e(1, 1, 1024), e(1, 77, 1024))
            cn_batch, cn_t = f, 981.0
        state["tower"] = "controlnet"
        ControlNetModel(device=META, dtype=f32)(e(cn_batch, 4, 64, 64), cn_t,
                                                e(cn_batch, 77, 768), e(cn_batch, 3, 512, 512))

    per_tower = _check_verdicts(seen, jnp.float32)
    bf16_rule = sum(gn.eligible(shape, 32, 2) for tower, flag, shape, _ in seen
                    if tower == "adapter")
    assert 0 < per_tower["adapter"] < bf16_rule, (per_tower, bf16_rule)
    if path == "sdxl":  # chip_smoke's count of SDXL's fp32 training run (phase 16 (2))
        assert per_tower["adapter"] == sum(chip_smoke.sdxl_k1_rows(batch=1, itemsize=4).values())
    if env is None:
        assert set(per_tower) == {"adapter"}
    assert not all(taken for *_, taken in seen)
