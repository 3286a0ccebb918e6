"""What the generation families share: configuration lists as tuples, the
seeded fill of a family's towers, one clip's inputs, the ``generate``
arguments and the decode as ``generate`` runs it."""

from __future__ import annotations

import torch

from harness import seeds, weights


def tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def make_towers(cfg: dict, unet_cls, unet_cfg, cnet_cls, cnet_cfg, adapter_cls, vae_cls,
                vae_cfg, **kw) -> dict:
    """{"unet", "controlnet", "adapter", "vae"} built from the given classes at
    the configuration's widths (``kw``: device and dtype)."""
    return dict(unet=unet_cls(unet_cfg(**tuples(cfg["unet"])), **kw),
                controlnet=cnet_cls(cnet_cfg(**tuples(cfg["controlnet"])), **kw),
                adapter=adapter_cls(**tuples(cfg["adapter"]), **kw),
                vae=vae_cls(vae_cfg(**tuples(cfg["vae"])), **kw))


def fill(towers: dict, cfg: dict, seed: int, device) -> int:
    """Fill each tower (by name, in the given order) from its own stream of
    ``seed``, rounded to the configuration's type; returns the count."""
    dtype = getattr(torch, cfg["dtype"])
    return sum(weights.fill(module.eval(), seeds.generator(device, seed, "weights", name),
                            cfg["weight_scale"], dtype) for name, module in towers.items())


def normal(gen, device, shape, scale=1.0, shared=0.0) -> torch.Tensor:
    """Normals of standard deviation ``scale`` (empty without ``gen``). With
    ``shared``, that share of the variance is one vector per sequence (the
    first axis) common to all its tokens (the second axis), as the tokens of
    one prompt are correlated in a text encoder's output."""
    shape = tuple(shape)
    if gen is None:
        return torch.empty(shape, device=device)
    x = torch.randn(shape, generator=gen, device=device)
    if shared:
        common = torch.randn((shape[0], 1) + shape[2:], generator=gen, device=device)
        x = shared ** 0.5 * common + (1.0 - shared) ** 0.5 * x
    return x * scale


def inputs(cfg: dict, device, gen=None) -> dict:
    """One clip's inputs, drawn from ``gen`` (empty tensors without one): the
    configuration's ``inputs`` ([shape, scale] or [shape, scale, shared], see
    ``normal``) in its type, a depth map per frame uniform in [0, 1) repeated
    to three channels, and the initial standard normal noise in float32."""
    dtype = getattr(torch, cfg["dtype"])
    g = cfg["generate"]
    f, h, w = g["num_frames"], g["height"], g["width"]
    out = {name: normal(gen, device, *spec).to(dtype) for name, spec in cfg["inputs"].items()}
    b = out["image_embeddings"].shape[0]
    depth = (torch.empty((b * f, h, w, 1), device=device) if gen is None else
             torch.rand((b * f, h, w, 1), generator=gen, device=device))
    out["control_images"] = depth.expand(-1, -1, -1, 3).to(dtype).contiguous()
    out["latents"] = normal(gen, device, (b, f, h // 8, w // 8, 4))
    return out


def generate_kwargs(cfg: dict) -> dict:
    return dict(cfg["generate"], output_type="np")


def decode(pipe, latents: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The program's decode of (b, f, h, w, 4) latents, as ``generate`` runs it."""
    return pipe._decode(latents, cfg["generate"]["vae_scaling_factor"])


def frames_per_clip(cfg: dict) -> int:
    return cfg["generate"]["num_frames"] * cfg["inputs"]["image_embeddings"][0][0]


def train_inputs(cfg: dict, device, gen=None):
    """One training step's batch and draws in the trainer's layouts, from
    ``gen`` (empty tensors without one): frames uniform in [-1, 1), a depth
    map per frame uniform in [0, 1) repeated to three channels as the one
    expert's condition, the configuration's embeddings (``normal``); the
    step's noise (VAE sample, latent noise, offset noise) and uniforms (time,
    dropout)."""
    t = cfg["train"]
    b, f = t["batch"], t["config"]["n_sample_frames"]
    h, w = t["height"], t["width"]
    lh, lw = h // 8, w // 8

    def draw(fn, shape):
        if gen is None:
            return torch.empty(shape, device=device)
        return fn(shape, generator=gen, device=device)

    batch = {"frames": draw(torch.rand, (b, f, h, w, 3)) * 2 - 1}
    depth = draw(torch.rand, (1, b * f, h, w, 1))
    batch["controlnet_cond"] = depth.expand(-1, -1, -1, -1, 3).contiguous()
    for name, spec in t["inputs"].items():
        batch[name] = normal(gen, device, *spec)
    draws = {"vae": draw(torch.randn, (b * f, lh, lw, 4)),
             "noise": draw(torch.randn, (b, f, lh, lw, 4)),
             "offset": draw(torch.randn, (b, 1, 1, 1, 4)),
             "time": draw(torch.rand, (b,)), "dropout": draw(torch.rand, (b,))}
    return batch, draws
