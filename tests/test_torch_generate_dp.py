"""Data-parallel generation, ``generate(..., mesh=...)``, over two CPU processes (gloo).

The port of the JAX pipelines' ``mesh=`` argument
(``ctrl_adapter_tpu/pipelines/{svd,i2vgenxl,sdxl}.py``; the JAX package's own
``tests/test_multi_device_generation.py``): the batch splits over the ranks
and the output equals the one-process run over the whole batch. Two
processes, started as ``tests/test_torch_train_ddp.py`` starts them (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, one thread each), join a
gloo group through ``parallel.mesh.join`` and run each pipeline at thin
widths on a global batch of 2, one video (image) a rank; they load the
pipelines this process built (``torch.save``), so both sides hold the same
weights.

- SVD (sparse key frames 0 and 2): the ranks' latents against the JAX
  package's ``generate(mesh=create_mesh(2))`` on the same weights (moved
  through ``convert/from_jax.py``) and latents; the ranks' video against the
  port's one-process run. The temporal transformers' single-key context
  pairs rows across the CFG batch (ROADMAP "reference behaviours"), so the
  batch-2 run differs from two batch-1 runs; the test checks that it does,
  by more than 4x its tolerance, so the global pairing (``global_rows``) is
  what the comparison holds.
- I2VGen-XL with 2 ControlNets and an embedding-conditioned router (whose
  input is the batch mean of the CLIP embeddings: the ranks all-reduce it),
  latents drawn from a seeded ``torch.Generator`` (every rank draws the whole
  batch and keeps its slice), the video and the router's trace; SDXL with
  rescaled CFG and IP-Adapter embeddings, drawn latents, the image; SDXL with
  an LCM UNet (``timestep_cond``, no CFG), the latents. Each against the
  port's one-process run; the JAX comparisons of I2VGen-XL and SDXL are
  marked ``slow``.
- A batch of 3 over 2 ranks raises "not divisible" in every pipeline.

Tolerance: rtol = atol = 2e-4, the JAX test's (summation order inside the
towers at another batch size; the all-reduced mean's order).
"""

import collections
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctrl_adapter_tpu.models.adapter import ControlNetAdapter as JAdapter
from ctrl_adapter_tpu.models.controlnet import ControlNetModel as JControlNet
from ctrl_adapter_tpu.models.router import ControlNetRouter as JRouter
from ctrl_adapter_tpu.models.router import build_router_input as jrouter_input
from ctrl_adapter_tpu.models.unet_2d import UNet2DConditionModel as JSDXLUNet
from ctrl_adapter_tpu.models.vae import AutoencoderKL as JVAE2D
from ctrl_adapter_tpu.models.vae import VAEConfig as JVAEConfig
from ctrl_adapter_tpu.models.vae_temporal import AutoencoderKLTemporalDecoder as JVAE
from ctrl_adapter_tpu.parallel.mesh import create_mesh
from ctrl_adapter_tpu.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline as JI2V
from ctrl_adapter_tpu.pipelines.svd import SVDControlNetAdapterPipeline as JSVD
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter, build_router_input
from ctrl_adapter_tpu_torch.models.vae import VAEConfig
from ctrl_adapter_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from ctrl_adapter_tpu_torch.parallel import mesh as meshes
from ctrl_adapter_tpu_torch.pipelines.svd import SVDControlNetAdapterPipeline

from . import test_torch_i2vgen_pipeline as i2v
from . import test_torch_port_svd as svd
from . import test_torch_sdxl_pipeline as sdxl
from .test_torch_port_modules import THIN_VAE
from .utils import fake_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, TOL = 2, 2e-4

_RANK = """
import sys, torch
sys.path[:0] = [{repo!r}]
torch.set_num_threads(1)
from ctrl_adapter_tpu_torch.parallel import mesh as meshes
mesh = meshes.join(torch.device("cpu"))
cases = torch.load({cases!r}, weights_only=False)
out = {{"rank": mesh.rank, "world": mesh.world_size}}
for name, (pipe, args, kwargs, odd_args) in cases.items():
    if "seed" in kwargs:
        kwargs = dict(kwargs, generator=torch.Generator().manual_seed(kwargs.pop("seed")))
    out[name] = pipe.generate(*args, mesh=mesh, **kwargs)
    if odd_args is not None:
        try:
            pipe.generate(*odd_args, mesh=mesh, **kwargs)
            out[name + "/odd"] = "no error"
        except ValueError as err:
            out[name + "/odd"] = str(err)
torch.save(out, {out!r})
# leave only once both ranks are done with every collective (through the
# store, not gloo), rank 0, which serves the store, last
store = torch.distributed.distributed_c10d._get_default_store()
store.set(f"done{{mesh.rank}}", "1")
store.wait(["done0", "done1"])
if mesh.rank:
    meshes.leave(mesh)
    store.set("left1", "1")
else:
    store.wait(["left1"])
    meshes.leave(mesh)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(tmp_path, cases):
    """Two gloo ranks running ``cases`` {name: (pipeline, args, kwargs, args
    of a batch of 3)}; returns a function that waits for them and returns
    each rank's outputs."""
    path = str(tmp_path / "cases.pt")
    torch.save(cases, path)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(2):
        code = _RANK.format(repo=REPO, cases=path, out=str(tmp_path / f"rank{rank}.pt"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank))))

    def wait(timeout=300):
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err[-4000:]
        ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
        assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
        return ranks

    return wait


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                               err_msg=f"{what}: max abs err {np.abs(got - want).max():.3e}")


def _both_ranks(ranks, name):
    """The two ranks' results of ``name``: the same global tensor on both."""
    a, b = ranks[0][name], ranks[1][name]
    if isinstance(a, tuple):  # (result, router trace down, mid)
        assert a[1:] == b[1:]
        a, b = a[0], b[0]
    assert torch.equal(a, b), name
    return ranks[0][name]


def _rows(a, n, dim=0):
    """``a`` repeated along ``dim`` to ``n`` rows."""
    return torch.cat([a] * -(-n // a.shape[dim]), dim).narrow(dim, 0, n)


# ---------------------------------------------------------------- the cases
def _fill(module, seed, scale):
    """Every parameter from a seeded torch generator, N(0, scale^2), as
    ``tests/utils.py:fake_init`` fills a JAX tree: the port-only cases need no
    JAX init."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return module.eval()


def _seeded(helpers, scale, seed=100):
    """Swap ``port`` in the ``helpers`` modules for a seeded fill, so their
    pipeline builders make port towers of the same configs without JAX
    params; returns the undo."""
    seeds = iter(range(seed, seed + 1000))
    saved = [h.port for h in helpers]
    for h in helpers:
        h.port = lambda module, _params: _fill(module, next(seeds), scale)
    return lambda: [setattr(h, "port", f) for h, f in zip(helpers, saved)]


def _svd_case(with_jax=True):
    """The thin SVD towers of ``tests/test_torch_port_svd.py``: the JAX
    pipeline and params (no VAE: the JAX side returns latents), the port's
    pipeline on the same weights with a seeded temporal VAE, inputs; without
    ``with_jax`` the port's towers seeded and the JAX side None."""
    jpipe = params = None
    if with_jax:
        vae = JVAE(config=JVAEConfig(**THIN_VAE, layers_per_block=1))
        unet, cnet, adapter, params = svd._params()
        jpipe = JSVD(unet=unet, controlnet=cnet, adapter=adapter, vae=vae)
        tunet, tcnet, tadapter = svd._port_towers(params)
    else:
        undo = _seeded([svd], 0.02)
        try:
            tunet, tcnet, tadapter = svd._port_towers(collections.defaultdict(dict))
        finally:
            undo()
    tvae = _fill(AutoencoderKLTemporalDecoder(VAEConfig(**THIN_VAE, layers_per_block=1)), 3,
                 0.02)
    rng = np.random.default_rng(11)
    f, hw = svd.F, svd.HW
    x = dict(image_emb=(rng.standard_normal((B, 1, 32)) * 8.0).astype(np.float32),
             image_latent=(rng.standard_normal((B, hw, hw, 4)) * 0.5).astype(np.float32),
             cn_prompt=(rng.standard_normal((2 * B, 7, 24)) * 0.5).astype(np.float32),
             ctrl=rng.uniform(0, 1, (B * f, 64, 64, 3)).astype(np.float32),
             latents=rng.standard_normal((B, f, hw, hw, 4)).astype(np.float32))
    kw = dict(height=hw * 8, width=hw * 8, num_frames=f, num_inference_steps=2,
              skip_conv_in=True, control_latent_size=hw, sparse_frames=(0, 2))
    return jpipe, params, SVDControlNetAdapterPipeline(tunet, tcnet, tadapter, tvae), x, kw


SVD_ARGS = ("image_emb", "image_latent", "cn_prompt", "ctrl")


def _svd_args(x, rows=slice(None)):
    cfg = np.concatenate([x["cn_prompt"][:B][rows], x["cn_prompt"][B:][rows]])
    f = svd.F
    ctrl = x["ctrl"].reshape(B, f, *x["ctrl"].shape[1:])[rows].reshape(-1, *x["ctrl"].shape[1:])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        x["image_emb"][rows], x["image_latent"][rows], cfg, ctrl))


def _i2v_case(with_jax=False, router_type="embedding_weights"):
    """Two ControlNets and an embedding-conditioned router over the thin
    I2VGen-XL towers of ``tests/test_torch_i2vgen_pipeline.py`` (temporal
    adapter blocks): (JAX pipeline, params, port pipeline, inputs, kwargs),
    the JAX ones None unless ``with_jax`` (else seeded port weights)."""
    router = ControlNetRouter(2, router_type, embedding_dim=32)
    jpipe = params = None
    if with_jax:
        unet, cnet, adapter, vae = i2v._jax_towers()
        jrouter = JRouter(num_experts=2, router_type=router_type)
        rin = jrouter_input(router_type, None, jnp.ones((1, 1, 32)))
        params = i2v._jax_params(unet, cnet, adapter, vae, router=jrouter,
                                 router_params=fake_init(jrouter, rin, seed=5, scale=0.5))
        jpipe = JI2V(unet=unet, controlnet=cnet, adapter=adapter, vae=vae, router=jrouter)
        tpipe = i2v._port_pipeline(params, router=router)
    else:
        undo = _seeded([i2v], 0.02)
        try:
            tpipe = i2v._port_pipeline(collections.defaultdict(dict), router=router)
        finally:
            undo()
        _fill(tpipe.router, 5, 0.5)
    rng = np.random.default_rng(12)
    r = lambda *s, scale=0.5: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x = dict(prompt=r(2 * B, 7, 32), cn_prompt=r(2 * B, 7, 24), image_emb=r(B, 1, 32, scale=2.0),
             ff_latent=r(B, i2v.HW, i2v.HW, 4),
             ctrl=rng.uniform(0, 1, (2, B * i2v.F, 64, 64, 3)).astype(np.float32),
             latents=r(B, i2v.F, i2v.HW, i2v.HW, 4, scale=1.0))
    kw = dict(num_inference_steps=3, control_guidance_end=0.67, **i2v.COMMON)
    return jpipe, params, tpipe, x, kw


I2V_ARGS = ("prompt", "cn_prompt", "image_emb", "ff_latent", "ctrl")


def _sdxl_case(lcm=False, with_jax=False):
    """The thin SDXL towers of ``tests/test_torch_sdxl_pipeline.py``: with
    IP-Adapter embeddings and CFG, or an LCM UNet without CFG; the JAX side
    None unless ``with_jax`` (else seeded port weights at its scale 0.1)."""
    extra = dict(time_cond_proj_dim=8) if lcm else dict(encoder_hid_dim_type="ip_image_proj")
    hid = None if lcm else sdxl.IP_DIM
    jpipe = params = None
    if with_jax:
        jpipe, params = sdxl._jax_setup(sdxl._unet_config(**extra), lcm=lcm, ip=not lcm)
        tpipe = sdxl._port_pipeline(jpipe, params, encoder_hid_dim=hid)
    else:  # the configs of _jax_setup's modules, which cost nothing without their init
        towers = SimpleNamespace(
            unet=JSDXLUNet(config=sdxl._unet_config(**extra)),
            controlnet=JControlNet(config=sdxl.CNET_CFG), vae=JVAE2D(config=sdxl.VAE_CFG),
            adapter=JAdapter(backbone_model_name="sdxl", num_blocks=1,
                             num_adapters_per_location=3, cross_attention_dim=32,
                             adapter_locations=("A",), add_temporal_resnet=False,
                             add_temporal_transformer=False,
                             custom_down_block_channels=(32,) * 3, attention_head_dim=16))
        undo = _seeded([sdxl], 0.1)
        try:
            tpipe = sdxl._port_pipeline(towers, collections.defaultdict(dict),
                                        encoder_hid_dim=hid)
        finally:
            undo()
    rng = np.random.default_rng(13)
    r = lambda *s, scale=0.5: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x = dict(prompt=r(2 * B, 7, 32), text=r(2 * B, 16), cn_prompt=r(2 * B, 7, 24),
             ctrl=rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
             latents=r(B, 16, 16, 4, scale=1.0), ip=r(B, sdxl.IP_DIM))
    kw = dict(height=128, width=128, control_latent_size=8, num_inference_steps=3,
              control_guidance_end=0.67)
    if lcm:
        kw.update(guidance_scale=4.0, output_type="latent")
    else:
        kw.update(guidance_scale=6.0, guidance_rescale=0.7,
                  ip_adapter_image_embeds=torch.from_numpy(x["ip"]))
    return jpipe, params, tpipe, x, kw


SDXL_ARGS = ("prompt", "text", "cn_prompt", "ctrl")


def _t(x, names):
    return tuple(torch.from_numpy(x[k]) for k in names)


# ------------------------------------------------------------------- tests
def test_two_gloo_ranks_generate_as_one_process(tmp_path):
    jsvd, sparams, tsvd, sx, skw = _svd_case()
    _, _, ti2v, ix, ikw = _i2v_case()
    _, _, tsdxl, dx, dkw = _sdxl_case()
    _, _, tlcm, lx, lkw = _sdxl_case(lcm=True)
    svd_args = _t(sx, SVD_ARGS)
    f = svd.F
    cases = {  # name: (pipeline, args, kwargs, args of a batch of 3)
        "svd-latent": (tsvd, svd_args, dict(skw, latents=torch.from_numpy(sx["latents"]),
                                            output_type="latent"),
                       tuple(_rows(a, n) for a, n in zip(svd_args, (3, 3, 6, 3 * f)))),
        "svd-video": (tsvd, svd_args, dict(skw, latents=torch.from_numpy(sx["latents"])), None),
        "i2vgenxl": (ti2v, _t(ix, I2V_ARGS), dict(ikw, seed=3, return_router_weights=True),
                     tuple(_rows(a, n, d) for a, (n, d) in zip(
                         _t(ix, I2V_ARGS), ((6, 0), (6, 0), (3, 0), (3, 0), (3 * i2v.F, 1))))),
        "sdxl": (tsdxl, _t(dx, SDXL_ARGS), dict(dkw, seed=4),
                 tuple(_rows(a, n) for a, n in zip(_t(dx, SDXL_ARGS), (6, 6, 6, 3)))),
        "sdxl-lcm": (tlcm, _t(lx, SDXL_ARGS), dict(lkw, seed=5), None),
    }
    wait = _start_ranks(tmp_path, cases)
    threads = torch.get_num_threads()
    try:  # the references in this process while the two ranks run
        torch.set_num_threads(1)
        mesh = create_mesh(2)
        want_jax = jsvd.generate(sparams, jax.random.PRNGKey(0),
                                 *(jnp.asarray(sx[k]) for k in SVD_ARGS),
                                 latents=jnp.asarray(sx["latents"]), mesh=mesh,
                                 output_type="latent", **skw)
        assert len(want_jax.sharding.device_set) == 2
        one = {
            "svd-latent": tsvd.generate(*svd_args, latents=torch.from_numpy(sx["latents"]),
                                        output_type="latent", **skw),
            "svd-video": tsvd.generate(*svd_args, latents=torch.from_numpy(sx["latents"]),
                                       **skw),
            "i2vgenxl": ti2v.generate(*_t(ix, I2V_ARGS), generator=torch.Generator()
                                      .manual_seed(3), return_router_weights=True, **ikw),
            "sdxl": tsdxl.generate(*_t(dx, SDXL_ARGS), generator=torch.Generator()
                                   .manual_seed(4), **dkw),
            "sdxl-lcm": tlcm.generate(*_t(lx, SDXL_ARGS), generator=torch.Generator()
                                      .manual_seed(5), **lkw),
        }
        # one video at a time: no pairing across the CFG batch
        singles = torch.cat([tsvd.generate(*_svd_args(sx, slice(v, v + 1)),
                                           latents=torch.from_numpy(sx["latents"][v:v + 1]),
                                           output_type="latent", **skw) for v in range(B)])
        ranks = wait()
    finally:
        torch.set_num_threads(threads)

    _close(_both_ranks(ranks, "svd-latent"), np.asarray(want_jax), "svd latents vs JAX mesh")
    for name in one:
        got, want = _both_ranks(ranks, name), one[name]
        if name == "i2vgenxl":  # and the router's trace, from the global embeddings
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL, atol=TOL)
            got, want = got[0], want[0]
        _close(got, want, f"{name} vs one process")
    assert np.abs(one["svd-latent"].numpy() - singles.numpy()).max() > 4 * TOL
    for name in ("svd-latent", "i2vgenxl", "sdxl"):
        assert "not divisible" in ranks[0][name + "/odd"], ranks[0][name + "/odd"]


def test_indivisible_batch_rejected():
    """A Mesh of 2 without a group: a batch of 3 raises before any work, in
    the words of the JAX pipelines, in each pipeline."""
    half = meshes.Mesh(rank=1, world_size=2)
    with pytest.raises(ValueError, match="batch 3 not divisible by data-axis size 2"):
        meshes.batch_rows(half, 3)
    z = torch.zeros
    runs = {
        "svd": lambda: _svd_case(with_jax=False)[2].generate(
            z(3, 1, 32), z(3, 8, 8, 4), z(6, 7, 24), z(12, 64, 64, 3), height=64, width=64,
            num_frames=4, mesh=half),
        "i2vgenxl": lambda: _i2v_case()[2].generate(
            z(6, 7, 32), z(6, 7, 24), z(3, 1, 32), z(3, 8, 8, 4), z(2, 12, 64, 64, 3),
            height=64, width=64, num_frames=4, mesh=half),
        "sdxl": lambda: _sdxl_case()[2].generate(
            z(6, 7, 32), z(6, 16), z(6, 7, 24), z(3, 64, 64, 3), height=128, width=128,
            mesh=half),
    }
    for name, run in runs.items():
        with pytest.raises(ValueError, match="batch 3 not divisible"):
            run()


def test_mesh_helpers_split_the_cfg_batch_and_pair_rows_globally():
    """``cfg_index`` takes each rank's [negatives; positives]; under
    ``global_rows`` the time context pairs a rank's rows as the global batch
    does: rank r's slice of the global context equals its local call's."""
    m = [meshes.Mesh(rank=r, world_size=2) for r in range(2)]
    assert [meshes.cfg_index(mi, 4).tolist() for mi in m] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    x = torch.arange(8.0)[:, None]
    assert meshes.take_cfg(m[1], x, 4)[:, 0].tolist() == [2, 3, 6, 7]
    # global CFG batch of 4 videos, 3 frames, 6 pixels: the whole batch's context
    g = torch.Generator().manual_seed(0)
    ehs = torch.randn(4 * 3, 1, 5, generator=g)
    whole = meshes.time_context(ehs, 4, 3, 6).reshape(4, 6, 1, 5)  # block rows v * hw + p
    first = ehs.reshape(4, 3, 1, 5)[:, 0]
    for mi in m:
        index = meshes.cfg_index(mi, 2)
        local = ehs.reshape(4, 3, 1, 5)[index].reshape(-1, 1, 5)
        with meshes.global_rows(meshes.GlobalRows(first, index)):
            got = meshes.time_context(local, 2, 3, 6)
        assert torch.equal(got, whole[index].reshape(-1, 1, 5))
    # without global rows a rank pairs within its own batch: another context
    assert not torch.equal(meshes.time_context(ehs.reshape(4, 3, 1, 5)[[2, 3]].reshape(-1, 1, 5),
                                               2, 3, 6), whole[[2, 3]].reshape(-1, 1, 5))


def test_router_mean_is_the_global_batch_mean():
    """The conditional router's input under a mesh: the all-reduced mean over
    every rank's videos (here a world of one without a group: the local
    mean); half the batch gives other weights, so the I2VGen-XL case above
    depends on it."""
    emb = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 1, 32))
                           .astype(np.float32) * 2.0)
    mean = meshes.all_reduce_mean(meshes.Mesh(), emb.mean(dim=1))
    torch.testing.assert_close(mean, emb.mean(dim=(0, 1)), rtol=1e-6, atol=1e-6)
    router = _i2v_case()[2].router
    full = router(build_router_input("embedding_weights", None, mean[None, None]))[0]
    half = router(build_router_input("embedding_weights", None, emb[:1]))[0]
    assert (full - half).abs().max() > 10 * TOL


@pytest.mark.slow
@pytest.mark.parametrize("pipeline", ["i2vgenxl", "sdxl"])
def test_two_gloo_ranks_generate_as_the_jax_mesh(tmp_path, pipeline):
    """I2VGen-XL (2 ControlNets, an embedding router) and SDXL (IP-Adapter,
    rescaled CFG): the ranks' latents against the JAX ``generate`` on a mesh
    of 2 devices, on the same weights and latents."""
    if pipeline == "i2vgenxl":
        jpipe, params, tpipe, x, kw = _i2v_case(with_jax=True)
        names = I2V_ARGS
    else:
        jpipe, params, tpipe, x, kw = _sdxl_case(with_jax=True)
        names = SDXL_ARGS
    kw = dict(kw, output_type="latent")
    wait = _start_ranks(tmp_path, {pipeline: (tpipe, _t(x, names),
                                              dict(kw, latents=torch.from_numpy(x["latents"])),
                                              None)})
    jkw = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v) for k, v in kw.items()}
    want = jpipe.generate(params, jax.random.PRNGKey(0), *(jnp.asarray(x[k]) for k in names),
                          latents=jnp.asarray(x["latents"]), mesh=create_mesh(2), **jkw)
    assert len(want.sharding.device_set) == 2
    ranks = wait()
    _close(_both_ranks(ranks, pipeline), np.asarray(want), f"{pipeline} vs JAX mesh")
