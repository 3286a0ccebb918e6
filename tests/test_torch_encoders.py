"""The port's CLIP towers, tokenizer, encoders, SVD image latent and resizes
against transformers (the oracle the JAX package's own tests use) and the JAX
package, fp32 on the CPU.

- Text tower (quick_gelu and gelu; with and without projection; both EOS
  pooling rules; ``clip_skip``) and vision tower, hidden width 32, 2 layers:
  within 2e-5 of transformers' torch CLIP and of the flax towers.
- Tokenizer: the ids of transformers' ``CLIPTokenizer`` (without ftfy) on a
  fabricated vocab, for prompts with punctuation, digits, accents, CJK, special
  tokens, an overlong one and empty strings, under both pad conventions.
- ``ControlNetTextEncoder``, ``CLIPTextEncoder`` (``clip_skip``,
  ``encode_with_pooled``) and both ``CLIPImageEncoder`` paths against the JAX
  classes on one fabricated folder: within 2e-5, except the processor path,
  whose pixels may differ from PIL's by one uint8 step before normalising.
  Without a device named they run on the card, and no card raises.
- ``antialiased_resize``, ``bicubic_resize_align_corners`` and
  ``encode_svd_image_latent`` (thin VAE, JAX's noise passed in) within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models import clip as jclip
from ctrl_adapter_tpu.models import text_encoders as jenc
from ctrl_adapter_tpu.models.vae import AutoencoderKL as JVAE
from ctrl_adapter_tpu.models.vae import VAEConfig as JVAEConfig
from ctrl_adapter_tpu.ops.resize import antialiased_resize as j_antialiased
from ctrl_adapter_tpu.ops.resize import bicubic_resize_align_corners as j_bicubic
from ctrl_adapter_tpu.pipelines.image_latents import encode_svd_image_latent as j_svd_latent
from ctrl_adapter_tpu_torch.models import text_encoders as tenc
from ctrl_adapter_tpu_torch.models.clip import (
    CLIPTextConfig, CLIPTextModel, CLIPVisionConfig, CLIPVisionModel)
from ctrl_adapter_tpu_torch.models.tokenizer import CLIPTokenizer
from ctrl_adapter_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from ctrl_adapter_tpu_torch.ops.resize import antialiased_resize, bicubic_resize_align_corners
from ctrl_adapter_tpu_torch.pipelines.image_latents import encode_svd_image_latent

import chip_smoke

from .torch_port_common import port
from .utils import fake_init

torch.set_num_threads(1)

TOL = 2e-5
PROMPTS = ["", "The cat and the dog!", "a photo of 3 cats, 12 dogs; and... more?!",
           "Café naïve résumé", "  tabs\tand\nnewlines  ", "under_score it's we're I'LL",
           "中文字 and more", "<|endoftext|>hello<|startoftext|>", "x y " * 60, "!!! wow!!", ""]


def _text_cfg(act, proj, eos):
    import transformers

    return transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=16, hidden_act=act,
        projection_dim=proj or 32, eos_token_id=eos)


@pytest.mark.parametrize("act,proj,eos", [("quick_gelu", None, 98), ("gelu", 24, 2)],
                         ids=["quick_gelu-eos98", "gelu-proj-legacy-eos"])
def test_text_tower_matches_transformers_and_flax(act, proj, eos):
    import transformers

    torch.manual_seed(0)
    hf_cfg = _text_cfg(act, proj, eos)
    oracle = (transformers.CLIPTextModel(hf_cfg) if proj is None
              else transformers.CLIPTextModelWithProjection(hf_cfg)).eval()
    cfg = CLIPTextConfig(vocab_size=99, hidden_size=32, num_layers=2, num_heads=4,
                         intermediate_size=64, max_position_embeddings=16, hidden_act=act,
                         eos_token_id=eos, projection_dim=proj)
    model = CLIPTextModel(cfg).eval()
    model.load_state_dict(oracle.state_dict(), strict=True)
    ids = torch.tensor([[1, 5, 7, 98, 98, 98], [2, 3, 97, 98, 98, 98]])
    with torch.no_grad():
        out = oracle(ids, output_hidden_states=True)
        last, pooled, hiddens = model(ids)
        skip_last, _, _ = model(ids, clip_skip=1)
    want_pool = out.text_embeds if proj else out.pooler_output
    for got, want in ((last, out.last_hidden_state), (pooled, want_pool),
                      (hiddens[-2], out.hidden_states[-2])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    np.testing.assert_allclose(
        skip_last.numpy(), oracle.text_model.final_layer_norm(out.hidden_states[-2]).detach(),
        atol=TOL)

    jmodel = jclip.CLIPTextModel(config=jclip.CLIPTextConfig(
        vocab_size=99, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        max_position_embeddings=16, hidden_act=act, eos_token_id=eos, projection_dim=proj))
    params = {"params": jclip.convert_clip_state_dict(
        {k: v.numpy() for k, v in oracle.state_dict().items()})}
    jlast, jpooled, jhiddens = jmodel.apply(params, jnp.asarray(ids.numpy()))
    jskip, _, _ = jmodel.apply(params, jnp.asarray(ids.numpy()), clip_skip=1)
    for got, want in ((last, jlast), (pooled, jpooled), (hiddens[-2], jhiddens[-2]),
                      (skip_last, jskip)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_vision_tower_matches_transformers_and_flax():
    import transformers

    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        image_size=32, patch_size=8, projection_dim=24, hidden_act="gelu")
    torch.manual_seed(0)
    oracle = transformers.CLIPVisionModelWithProjection(hf_cfg).eval()
    model = CLIPVisionModel(CLIPVisionConfig(
        image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, projection_dim=24)).eval()
    model.load_state_dict(oracle.state_dict(), strict=True)
    pix = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        out = oracle(pix)
        last, embeds = model(pix)
    np.testing.assert_allclose(embeds.numpy(), out.image_embeds.numpy(), atol=TOL)
    np.testing.assert_allclose(last.numpy(), out.last_hidden_state.numpy(), atol=TOL)

    jmodel = jclip.CLIPVisionModel(config=jclip.CLIPVisionConfig(
        image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, projection_dim=24))
    params = {"params": jclip.convert_clip_state_dict(
        {k: v.numpy() for k, v in oracle.state_dict().items()})}
    _, jembeds = jmodel.apply(params, jnp.asarray(pix.numpy().transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(embeds.numpy(), np.asarray(jembeds), atol=TOL)


@pytest.mark.parametrize("pad", ["<|endoftext|>", "!"], ids=["pad-eos", "pad-bang"])
def test_tokenizer_matches_transformers(pad, tmp_path):
    import transformers

    words = "the cat and dog photo cats dogs more café naïve wow under score".split()
    chip_smoke.write_tokenizer(str(tmp_path), pad_token=pad, words=words)
    hf = transformers.CLIPTokenizer.from_pretrained(str(tmp_path))
    mine = CLIPTokenizer.from_pretrained(str(tmp_path))
    want = hf(PROMPTS, padding="max_length", truncation=True, max_length=hf.model_max_length,
              return_tensors="np")["input_ids"]
    got = mine(PROMPTS).numpy()
    assert got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
    assert got[0, 2] == mine.encoder[pad]


TEXT = CLIPTextConfig(vocab_size=1024, hidden_size=32, num_layers=2, num_heads=4,
                      intermediate_size=64, eos_token_id=2)
TEXT2 = CLIPTextConfig(vocab_size=1024, hidden_size=48, num_layers=2, num_heads=4,
                       intermediate_size=64, hidden_act="gelu", eos_token_id=2,
                       projection_dim=40)
VISION = CLIPVisionConfig(image_size=224, patch_size=32, hidden_size=32, num_layers=2,
                          num_heads=4, intermediate_size=64, projection_dim=24)


@pytest.fixture(scope="module")
def encoder_dir(tmp_path_factory):
    """A fabricated diffusers folder: text_encoder/ + tokenizer/, text_encoder_2/
    (with projection), image_encoder/ + feature_extractor/."""
    root = str(tmp_path_factory.mktemp("encoders"))
    chip_smoke.write_text_encoder(root, TEXT, 1, torch.float32, "cpu")
    chip_smoke.write_text_encoder(root, TEXT2, 2, torch.float16, "cpu",
                                  subfolder="text_encoder_2", tokenizer="tokenizer_2")
    chip_smoke.write_image_encoder(root, VISION, 3, torch.float32, "cpu")
    return root


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


def test_text_encoders_match_jax(encoder_dir, monkeypatch):
    prompts, negs = [chip_smoke.CLI_PROMPT], ["blurry, low quality"]
    _close(tenc.ControlNetTextEncoder(encoder_dir, device="cpu")(prompts, negs),
           jenc.ControlNetTextEncoder(encoder_dir)(prompts, negs))
    for skip in (0, 1):
        _close(tenc.CLIPTextEncoder(encoder_dir, clip_skip=skip, device="cpu")(prompts),
               jenc.CLIPTextEncoder(encoder_dir, clip_skip=skip)(prompts))
    for sub, proj in (("text_encoder", False), ("text_encoder_2", True)):
        got = tenc.CLIPTextEncoder(encoder_dir, subfolder=sub, with_projection=proj,
                                   device="cpu").encode_with_pooled(prompts)
        want = jenc.CLIPTextEncoder(encoder_dir, subfolder=sub,
                                    with_projection=proj).encode_with_pooled(prompts)
        for g, w in zip(got, want):
            _close(g, w)
    with pytest.raises(ValueError, match="controlnet_text_encoder_path"):
        tenc.build_controlnet_text_encoder(encoder_dir, None, "svd")
    # no device named: the card, and no card raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tenc.ControlNetTextEncoder(encoder_dir),
                  lambda: tenc.CLIPTextEncoder(encoder_dir),
                  lambda: tenc.build_controlnet_text_encoder(encoder_dir, encoder_dir, "sdxl"),
                  lambda: tenc.CLIPImageEncoder(encoder_dir)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_image_encoder_matches_jax(encoder_dir):
    rng = np.random.default_rng(4)
    frame = chip_smoke.smooth_frames(rng, 1, 96)[0]
    frame = np.concatenate([frame, frame[:, :40]], axis=1)  # 96 x 136, not square
    port_enc = tenc.CLIPImageEncoder(encoder_dir, device="cpu")
    jax_enc = jenc.CLIPImageEncoder(encoder_dir)
    _close(port_enc([frame], antialiased=True), jax_enc([frame], antialiased=True))
    # the processor path: pixels within one uint8 step of PIL's before normalising
    got = port_enc._process([frame]).numpy()
    want = jax_enc.processor(images=[frame], return_tensors="np")["pixel_values"]
    step = 1.0 / 255 / np.asarray(port_enc.processor["image_std"])[None, :, None, None]
    assert got.shape == want.shape
    assert (np.abs(got - want) <= step * 1.001).all()
    with torch.no_grad():
        _, emb = port_enc.model(torch.from_numpy(want))
    _close(port_enc([frame]), port_enc.model(port_enc._process([frame]))[1][:, None],
           atol=0)
    _, jemb = jax_enc.model.apply(jax_enc.params, jnp.asarray(want.transpose(0, 2, 3, 1)))
    _close(emb, jemb)


def test_resizes_and_svd_image_latent_match_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 96, 136, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    _close(antialiased_resize(xt, (224, 224)).permute(0, 2, 3, 1),
           j_antialiased(jnp.asarray(x), (224, 224)), atol=1e-5)
    _close(antialiased_resize(xt, (40, 52)).permute(0, 2, 3, 1),
           j_antialiased(jnp.asarray(x), (40, 52)), atol=1e-5)
    _close(bicubic_resize_align_corners(xt, (50, 70)).permute(0, 2, 3, 1),
           j_bicubic(jnp.asarray(x), (50, 70)), atol=1e-5)

    cfg = dict(block_out_channels=(16, 16, 16, 16), norm_num_groups=8, layers_per_block=1)
    jvae = JVAE(config=JVAEConfig(**cfg))
    params = fake_init(jvae, jnp.ones((1, 64, 64, 3)), seed=6, scale=0.1)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = j_svd_latent(jvae, params, img, key, noise_aug_strength=0.02)
    noise = np.array(jax.random.normal(key, (1, 64, 64, 3), jnp.float32))
    vae = port(AutoencoderKL(VAEConfig(**cfg)), params)
    got = encode_svd_image_latent(vae, torch.from_numpy(img), noise=torch.from_numpy(noise),
                                  noise_aug_strength=0.02)
    assert got.shape == (1, 8, 8, 4)
    _close(got, want, atol=1e-5)
    with pytest.raises(ValueError):
        encode_svd_image_latent(vae, torch.from_numpy(img))
