"""``train_torch.py``, its YAML reader and the JAX init rules, on the CPU.

- The YAML reader (``config.parse_yaml``, no PyYAML) against PyYAML's
  ``safe_load`` on the 12 ``configs/*.yaml`` (three with an anchor and an
  alias) and on edge cases; what lies outside its subset (among it
  yes/no/on/off, .inf/.nan, escapes in quoted strings, an anchor on a
  scalar) raises ``ValueError`` naming the line.
- The flags: the CLI's parsed and merged namespace equals the JAX parser's
  (``add_train_args`` + ``merge_yaml_over_args``) with ``train.py``'s own
  flags, and its ``TrainConfig`` equals ``train.py:build_trainer``'s, for
  every config (dataclasses only, nothing compiled).
- The init rules (``train/init.py``) against one jitted JAX ``adapter.init``
  of a small adapter that holds every kind of adapter parameter (spatial and
  temporal ResNets and transformers, time embeddings, mix factors,
  ``zero_convs``): zero where JAX is zero, one where JAX is one, the mix
  factors equal, each kernel's std within a 5-sigma band of sampling error
  (``5 / sqrt(2 n)`` relative) of 1/sqrt(fan_in), as JAX's is, and bounded
  by the truncation at two standard deviations; the router's gates at
  std 1/sqrt(in). A fresh trainer's masters are these fp32 draws, and its
  bf16 module their cast.
- The CLI at thin widths (``tests/torch_cli_common.py:thin_train_modules``
  in place of ``train_torch.build_modules``), ``main(argv, device="cpu")``:
  SVD (3 steps), I2VGen-XL with 3 ControlNets and a simple-weights router
  (1-2 active) and SDXL (2 steps each) equal, bit for bit, the port's
  ``CtrlAdapterTrainer`` driven by hand on the same towers, batches and
  draws; the log's records and the checkpoints (at ``checkpointing_steps``,
  at the last step, from ``save_starting_step`` on); a resume from
  ``checkpoint-2`` for step 3 equal to the uninterrupted run; the trained
  ``adapter_{step}/`` and ``router_{step}/`` served by ``inference_torch.main``;
  the frozen towers loaded from diffusers folders, with a per-type tower of
  mixed-type training resident; the dataset path (``_real_data``: thin
  diffusers folders, two PNG-frame clips, a thin ``Intel/dpt-large`` named by
  ``CTRL_ADAPTER_ANNOTATORS``): two SVD depth steps with the log, a
  checkpoint and validation on the step's batch with its ``_concat.gif``,
  and, under ``--mixed_control_types_training depth canny``, each step run
  by the ControlNet of its batch's type; an unported type refused before
  anything is built, and a missing card; and one run of each data path with
  yaml, cv2, imageio, PIL, safetensors, transformers, wandb and JAX blocked,
  as on the card's host.
"""

import argparse
import glob
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import chip_smoke
import inference_torch
import train_torch
from ctrl_adapter_tpu_torch.conditions import MULTI_CONDITION_EXPERT_ORDER
from ctrl_adapter_tpu_torch.convert.release import save_release
from ctrl_adapter_tpu_torch.config import load_yaml, parse_yaml
from ctrl_adapter_tpu_torch.convert.from_jax import _TO_TORCH, _flatten, jax_path
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter
from ctrl_adapter_tpu_torch.train import checkpoints
from ctrl_adapter_tpu_torch.train import init as tinit
from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer

from . import torch_cli_common as tc
from .test_torch_inference_cli import _jax_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


# ------------------------------------------------------------------- YAML
@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(c) for c in CONFIGS])
def test_yaml_reader_matches_pyyaml_on_the_configs(path):
    assert len(CONFIGS) == 12
    with open(path) as fh:
        want = yaml.safe_load(fh)
    got = load_yaml(path)
    assert got == want and list(got) == list(want)
    if "mixed" in path:  # the anchor and its alias: one list, as PyYAML gives
        assert got["control_types"] is got["mixed_control_types_training"]


@pytest.mark.parametrize("text", [
    "a: 5.0", "a: 1e-4", "a: 1.0e-4", "a: 1.0e4", "a: .5", "a: -1", "a: +3", "a: 0", "a: []",
    "a: [ ]  # empty", "a: null", "a: ~", "a:", "a: true", "a: FALSE",
    "a: b  # trailing", "a: b#c", "a: 'x # y'  # c", 'a: "q x"',
    "a: hello world", "a: x,y", "a: 2.5e+3",
    "# head\na:\n- 1\n- x  # c\n-\n- 'q'\n\nb: 3",
    "a:\n  - A\n  - B\nb: &id001\n- depth\nc: *id001",
], ids=lambda t: t.replace("\n", "|"))
def test_yaml_reader_edge_cases_match_pyyaml(text):
    got, want = parse_yaml(text), yaml.safe_load(text)
    assert json.dumps(got) == json.dumps(want) and got.keys() == want.keys()


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb:\n  c: 2", 3), ("a: {b: 1}", 1), ("a: [1, 2]", 1), ("a: |\n  x", 1),
    ("a: 010", 1), ("a: 0x1f", 1), ("a: 1_000", 1), ("a: 2001-12-14", 1), ("a: 1:20", 1),
    ("x: 1\n  a: 1", 2), ("a: 1\na: 2", 2), ("a: b: c", 1), ("a: *nope", 1),
    ("a:\n - 1\n  - 2", 3), ("a: !!str 3", 1), ("- 1", 1), ("a:\tb", 1), ("a: 'x", 1),
    ('a: "\\x41"', 1), ("---\na: 1", 1), ("a: 1\nb: Off", 2), ("a: yes", 1), ("a: -.inf", 1),
    ('a: "q\\"x\\n"', 1), ("a: 'it''s'", 1), ("a: &n 3\nb: *n", 1),
], ids=lambda v: str(v).replace("\n", "|"))
def test_yaml_reader_rejects_what_lies_outside_its_subset(text, line):
    with pytest.raises(ValueError, match=f"line {line}: "):
        parse_yaml(text)


# ------------------------------------------------------------------ flags
CLI_FLAGS = ("fake_weights", "synthetic_data", "run_validation", "use_wandb", "multihost")


@pytest.mark.parametrize("yaml_file", [None] + CONFIGS,
                         ids=["defaults"] + [os.path.basename(c) for c in CONFIGS])
def test_flags_and_train_config_match_the_jax_cli(yaml_file):
    """The namespace and ``TrainConfig`` of ``train_torch`` against
    ``train.py``'s parser (``add_train_args``, its five flags, the YAML merge)
    and ``build_trainer``."""
    from ctrl_adapter_tpu import config as jconfig

    train = _jax_cli("train")
    argv = [] if yaml_file is None else ["--yaml_file", yaml_file]
    args = train_torch.parse_args(argv)
    parser = argparse.ArgumentParser()
    jconfig.add_train_args(parser)
    for flag in CLI_FLAGS:
        parser.add_argument(f"--{flag}", action="store_true")
    jargs = parser.parse_args(argv)
    jargs = jconfig.merge_yaml_over_args(jargs, jargs.yaml_file)
    assert vars(args) == vars(jargs)
    want = train.build_trainer(args).config
    got = train_torch.train_config(args)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
        f: getattr(want, f) for f in want.__dataclass_fields__}


# ------------------------------------------------------------- init rules
N = 4
INIT_ADAPTER = dict(backbone_model_name="i2vgenxl", num_blocks=1, num_adapters_per_location=1,
                    cross_attention_dim=32, adapter_locations=("A", "M"),
                    add_temporal_resnet=True, add_temporal_transformer=True,
                    custom_down_block_channels=(32,), custom_mid_block_channels=64,
                    attention_head_dim=16, num_repeats=2, out_channels=32)


def _kernel_band(std, fan_in, n):
    """std within 5 sampling sigmas (relative 5 / sqrt(2 n)) of 1/sqrt(fan_in)."""
    return abs(std * math.sqrt(fan_in) - 1.0) <= 5.0 / math.sqrt(2 * n)


def test_init_rules_match_flax_defaults():
    from ctrl_adapter_tpu.models.adapter import ControlNetAdapter as JAdapter

    jadapter = JAdapter(**INIT_ADAPTER)
    args = ([jnp.zeros((N, 8, 8, 32))] * 12, jnp.zeros((N, 1, 1, 64)), 4, jnp.ones((N,)),
            jnp.ones((1, 1, 32)))
    jflat = _flatten(jax.tree.map(np.asarray, jax.jit(
        lambda k: jadapter.init(k, *args))(jax.random.PRNGKey(0))["params"]))
    adapter = ControlNetAdapter(**INIT_ADAPTER)
    state = tinit.adapter_state(adapter, torch.Generator().manual_seed(0))
    assert {jax_path(k, v.dim()) for k, v in state.items()} == set(jflat)
    kinds = {"zero": 0, "one": 0, "mix": 0, "kernel": 0}
    pooled = {"port": [], "jax": []}
    for name, t in state.items():
        want = jflat[jax_path(name, t.dim())]
        if jax_path(name, t.dim())[-1] == "kernel":
            want = want.transpose(_TO_TORCH[want.ndim])
        assert t.dtype == torch.float32 and t.shape == want.shape, name
        t = t.numpy()
        if (want == 0).all():
            assert (t == 0).all(), name
            kinds["zero"] += 1
        elif (want == 1).all():
            assert (t == 1).all(), name
            kinds["one"] += 1
        elif name.endswith("mix_factor"):
            np.testing.assert_array_equal(t, want)
            kinds["mix"] += 1
        else:  # a kernel: lecun_normal
            assert name.endswith(".weight") and t.ndim >= 2, name
            fan_in, n = math.prod(t.shape[1:]), t.size
            for who, x in (("port", t), ("jax", want)):
                assert _kernel_band(float(x.std()), fan_in, n), (name, who, float(x.std()))
                pooled[who].append(float(x.std()) * math.sqrt(fan_in))
            assert np.abs(t).max() <= 2 / tinit.TRUNCATED_STD / math.sqrt(fan_in) + 1e-7
            assert abs(float(t.mean())) <= 5 / math.sqrt(fan_in * n)
            kinds["kernel"] += 1
    assert kinds == {"zero": 109, "one": 36, "mix": 6, "kernel": 105}, kinds
    for who, stds in pooled.items():  # over all 105 kernels, within 1 %
        assert abs(np.mean(stds) - 1.0) < 0.01, who
    # PyTorch's default init is a third of the variance: what the rule repairs
    default = dict(adapter.named_parameters())["mid_block_adapter.proj_in.weight"]
    assert abs(float(default.detach().std()) * math.sqrt(64) - 3 ** -0.5) < 0.05

    router = ControlNetRouter(7, "embedding_weights", embedding_dim=1024)
    gates = tinit.router_state(router, torch.Generator().manual_seed(1))
    assert len(gates) == 13 and all(abs(float(g.std()) * 32 - 1) < 0.05 for g in gates.values())


def test_fresh_masters_are_fp32_draws(thin_train):
    """With bf16 modules, a fresh trainer's masters are the fp32 draws (few
    of a kernel's values are bf16 numbers) and the module holds their cast."""
    args = thin_train.parse_args(_argv("svd", "--mixed_precision", "bf16"))
    trainer = thin_train.build_trainer(args, torch.device("cpu"))
    tinit.init_trainable(trainer, torch.Generator().manual_seed(3))
    rounded = []
    for name, p, m in zip(trainer.names, trainer.optimizer.params, trainer.optimizer.masters):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p, m.to(torch.bfloat16)), name
        if name.endswith("weight") and m.dim() >= 2:
            rounded.append(float((m == m.to(torch.bfloat16).float()).double().mean()))
    assert len(rounded) > 100 and max(rounded) < 0.01


# -------------------------------------------------------------------- the CLI
def _argv(model, *extra, size=None):
    """Thin-run flags: 3 frames at 64^2 (SDXL: 1024^2, where train.py's
    control latent is half the UNet's), fp32."""
    size = size or {"svd": 64, "i2vgenxl": 64, "sdxl": 1024}[model]
    return ["--model_name", model, "--height", str(size), "--width", str(size),
            "--n_sample_frames", str(tc.FRAMES), "--mixed_precision", "no", "--seed", "7",
            "--cross_attention_dim", "2048" if model == "sdxl" else "1024", *extra]


CASES = {
    "svd": ("svd", ["--skip_conv_in", "True", "--max_train_steps", "3",
                    "--checkpointing_steps", "2", "--run_validation",
                    "--validate_every_steps", "3"], [2, 3]),
    "i2vgenxl-router": ("i2vgenxl", ["--n_sample_frames", "4",
                                     "--control_types", "depth", "canny", "normal",
                                     "--multi_source_random_select_control_types", "True",
                                     "--max_num_multi_source_train", "2",
                                     "--max_train_steps", "2", "--checkpointing_steps", "5",
                                     "--apply_sparse_frame_mask", "True"], [2]),
    "sdxl": ("sdxl", ["--adapter_locations", "B", "--num_adapters_per_location", "1",
                      "--snr_gamma", "5.0", "--max_train_steps", "2",
                      "--save_starting_step", "3"], []),
}


@pytest.fixture
def thin_train(monkeypatch):
    monkeypatch.setattr(train_torch, "build_modules", tc.thin_train_modules)
    return train_torch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The thin CLI run of each case, {case: (run, DATA_PATH)}."""
    original = train_torch.build_modules
    train_torch.build_modules = tc.thin_train_modules
    try:
        out = {}
        for case, (model, flags, _) in CASES.items():
            data = str(tmp_path_factory.mktemp(case))
            out[case] = (train_torch.main(_argv(model, "--fake_weights", "--DATA_PATH", data,
                                                *flags), device="cpu"), data)
        return out
    finally:
        train_torch.build_modules = original


def _by_hand(model, flags, steps):
    """The port's trainer driven by hand: the thin towers, the frozen ones
    filled and the trainable ones drawn as ``--fake_weights`` draws them, and
    each step's batch (``train.py:389-415``'s draws from numpy's generator of
    (seed, step)), sparse frames and noise; returns the trainer, each step's
    metrics and expert mask."""
    args = train_torch.parse_args(_argv(model, "--fake_weights", *flags))
    cfg = train_torch.train_config(args)
    unet, nets, adapter, vae, router = tc.thin_train_modules(args, cfg.num_experts, "cpu")
    trainer = CtrlAdapterTrainer(cfg, unet, MultiControlNetModel(nets) if router else nets[0],
                                 adapter, vae, router=router, device="cpu")
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for module in (unet, vae, *nets):
            for p in module.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * train_torch.FAKE_WEIGHT_SCALE)
    tinit.init_trainable(trainer, torch.Generator().manual_seed(7))
    f, size = (1 if model == "sdxl" else args.n_sample_frames), args.height
    s8, experts = cfg.control_latent_size * 8, cfg.num_experts
    metrics, masks = [], []
    for step in range(1, steps + 1):
        rng = np.random.default_rng([7, step])
        gen = torch.Generator().manual_seed(int(rng.integers(2 ** 62)))
        batch = {"frames": rng.uniform(-1, 1, (1, f, size, size, 3)),
                 "controlnet_cond": rng.uniform(0, 1, (experts, f, s8, s8, 3)),
                 "controlnet_text_emb": rng.standard_normal((1, 77, 768)).astype(np.float32) * 0.1}
        wide = 2048 if model == "sdxl" else 1024
        batch["prompt_embeds"] = rng.standard_normal((1, 77, wide)).astype(np.float32) * 0.1
        if model == "sdxl":
            batch.update(pooled_prompt_embeds=np.full((1, 1280), 0.1),
                         additional_time_ids=np.ones((1, 6)))
        else:
            batch["image_embeddings"] = np.full((1, 1, 1024), 0.1)
        mask = None
        if experts > 1:
            mask = np.zeros(experts)
            mask[rng.choice(experts, rng.integers(1, 3), replace=False)] = 1
            batch["expert_mask"] = mask
        sparse = (sorted(rng.choice(f, int(rng.integers(1, 5)), replace=False).tolist())
                  if args.apply_sparse_frame_mask else None)
        batch = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in batch.items()}
        draws = trainer.draw(gen, 1, f, size // 8, size // 8)
        metrics.append(trainer.train_step(batch, sparse, draws=draws))
        masks.append(None if mask is None else mask.tolist())
    return trainer, metrics, masks


@pytest.mark.parametrize("case", list(CASES))
def test_cli_steps_equal_the_trainer_by_hand(case, runs):
    model, flags, want_ckpts = CASES[case]
    run, data = runs[case]
    steps = len(run.records)
    trainer, metrics, masks = _by_hand(model, flags, steps)
    for a, b in zip(run.trainer.optimizer.masters, trainer.optimizer.masters):
        assert torch.equal(a, b)
    assert run.trainer.optimizer.update_count == trainer.optimizer.update_count == steps
    with open(os.path.join(data, "train_log.jsonl")) as fh:
        logged = [json.loads(line) for line in fh]
    assert logged == run.records and [r["step"] for r in logged] == list(range(1, steps + 1))
    for rec, m in zip(logged, metrics):
        assert rec["loss"] == float(m["loss"]) and rec["lr"] == 5e-5 and rec["loss_time"] > 0
        if "down_block_weights" in m:
            assert rec["down_block_weights"] == m["down_block_weights"].tolist()
    assert run.expert_masks == masks
    for rec, mask in zip(logged, masks):
        if mask is not None:  # the masked experts weigh exactly 0
            w = np.asarray(rec["down_block_weights"])
            assert 0.0 in mask and (w[:, np.asarray(mask) == 0] == 0).all()
    assert sorted(os.listdir(data)) == sorted(
        ["train_log.jsonl"] + [f"checkpoint-{s}" for s in want_ckpts]
        + (["validation"] if run.validations else []))
    assert run.checkpoints == [os.path.join(data, f"checkpoint-{s}") for s in want_ckpts]
    for s in want_ckpts:
        loaded = checkpoints.load_checkpoint(os.path.join(data, f"checkpoint-{s}"), s)
        assert loaded["config"]["model_name"] == model
        assert ("router" in loaded) == (model == "i2vgenxl")
    if model == "svd":
        assert run.validations == [os.path.join(data, "validation", "step_3.gif")]
        assert tc.frames_of(run.validations[0]).shape == (tc.FRAMES, 64, 64, 3)


def test_cli_resume_equals_the_uninterrupted_run(runs, thin_train, tmp_path):
    """``checkpoint-2`` of the SVD run, resumed for step 3: the restored
    masters and optimizer state equal what was written, and after step 3
    they equal the uninterrupted run's, bit for bit; with
    ``--disable_optimizer_restore`` only the masters come back."""
    run, data = runs["svd"]
    model, flags, _ = CASES["svd"]
    ckpt = os.path.join(data, "checkpoint-2")
    restored = {}
    step = CtrlAdapterTrainer.train_step

    def first_step(self, *a, **k):  # the state as restored, before step 3
        restored.setdefault("masters", [m.clone() for m in self.optimizer.masters])
        restored.setdefault("update_count", self.optimizer.update_count)
        return step(self, *a, **k)

    saved = checkpoints.load_checkpoint(ckpt, 2)
    resume = ["--adapter_resume_path", ckpt, "--adapter_resume_step", "2",
              "--validate_every_steps", "100", "--save_starting_step", "100"]
    CtrlAdapterTrainer.train_step = first_step
    try:
        again = thin_train.main(_argv(model, "--fake_weights", "--DATA_PATH", str(tmp_path),
                                      *flags, *resume), device="cpu")
    finally:
        CtrlAdapterTrainer.train_step = step
    n = len(again.trainer.names)
    assert all(torch.equal(m, saved["adapter"][name]) for name, m in
               zip(again.trainer.names, restored["masters"][:n]))
    assert restored["update_count"] == 2
    assert [r["step"] for r in again.records] == [3] and again.records[0] == {
        **run.records[2], "loss_time": again.records[0]["loss_time"]}
    for a, b in zip(again.trainer.optimizer.masters, run.trainer.optimizer.masters):
        assert torch.equal(a, b)
    want, got = (t.optimizer.state_dict() for t in (run.trainer, again.trainer))
    assert got["update_count"] == want["update_count"] == 3
    for i, st in want["adamw"]["state"].items():
        assert all(torch.equal(st[k], got["adamw"]["state"][i][k]) for k in st)
    fresh = thin_train.main(_argv(model, "--fake_weights", "--DATA_PATH", str(tmp_path / "f"),
                                  *flags, *resume, "--disable_optimizer_restore", "True"),
                            device="cpu")
    assert fresh.trainer.optimizer.update_count == 1


def test_trained_checkpoints_serve_in_inference_cli(runs, thin_train, tmp_path, monkeypatch):
    """The SVD run's ``adapter_3/``, and the ``adapter_1/`` and ``router_1/``
    of a run with the seven experts of a multi-condition checkpoint, load in
    ``inference_torch.main`` (real-weights path, the other towers from
    diffusers folders) as the trainer's masters, and serve a video."""
    monkeypatch.setattr(inference_torch, "build_modules", tc.thin_build_modules)
    types = list(MULTI_CONDITION_EXPERT_ORDER)
    fixture = tc.write_fixture(str(tmp_path / "fixture"), types)
    multi = thin_train.main(_argv(
        "i2vgenxl", "--fake_weights", "--control_types", *types,
        "--multi_source_random_select_control_types", "True", "--max_train_steps", "1",
        "--DATA_PATH", str(tmp_path / "multi")), device="cpu")
    served = {"svd": (runs["svd"][0], ["depth"], 3), "i2vgenxl": (multi, types, 1)}
    for model, (run, ctypes, step) in served.items():
        ckpt = run.checkpoints[-1]
        src = tc.thin_build_modules(argparse.Namespace(model_name=model, control_types=ctypes),
                                    "cpu")
        flags = tc.write_thin_release(src, model, str(tmp_path / f"release_{model}"))
        flags += ["--adapter_checkpoint_path", os.path.join(ckpt, f"adapter_{step}")]
        if model == "i2vgenxl":
            flags += ["--router_checkpoint_path", os.path.join(ckpt, f"router_{step}")]
        out = inference_torch.main(tc.cli_argv(model, ctypes, fixture, str(tmp_path / model),
                                               *flags), device="cpu")
        for name, state in (("adapter", run.trainer.adapter_state()),
                            ("router", run.trainer.router_state())):
            if state is not None:
                got = getattr(out.pipe, name).state_dict()
                assert got.keys() == state.keys()
                assert all(torch.equal(got[k], v) for k, v in state.items()), name
        video = out.videos["s0"]
        assert video.shape == (1, tc.FRAMES, 64, 64, 3) and np.isfinite(video).all()


def test_cli_loads_diffusers_folders_with_mixed_type_towers(thin_train, tmp_path):
    """Real weights: the UNet, the VAE and the ControlNet of the first type
    load into the trainer, the second type's ControlNet stays resident
    beside it (``--mixed_control_types_training depth canny``), every tensor
    as written; one synthetic step trains."""
    src = tc.thin_build_modules(argparse.Namespace(model_name="i2vgenxl",
                                                   control_types=["depth", "canny"]), "cpu")
    root = str(tmp_path / "release")
    for i, module in enumerate((src.unet, src.vae, *src.controlnet.nets)):
        chip_smoke.random_fill(module, 40 + i, scale=0.05)
    for name in ("unet", "vae"):
        save_release(getattr(src, name).state_dict(), os.path.join(root, name))
    flags = ["--pretrained_model_path", root,
             "--controlnet_model_paths", *src.controlnet.save_pretrained(root)]
    run = thin_train.main(_argv("i2vgenxl", "--synthetic_data", "--max_train_steps", "1",
                                "--mixed_control_types_training", "depth", "canny",
                                "--DATA_PATH", str(tmp_path / "out"), *flags), device="cpu")
    trainer = run.trainer
    assert set(run.controlnet_by_type) == {"depth", "canny"}
    assert run.controlnet_by_type["depth"] is trainer.experts[0]
    pairs = [(trainer.unet, src.unet), (trainer.vae, src.vae),
             (run.controlnet_by_type["depth"], src.controlnet.nets[0]),
             (run.controlnet_by_type["canny"], src.controlnet.nets[1])]
    for got, want in pairs:
        g = got.state_dict()
        assert g.keys() == want.state_dict().keys()
        assert all(torch.equal(g[k], v) for k, v in want.state_dict().items())
    assert math.isfinite(run.records[0]["loss"])
    with pytest.raises(SystemExit, match="controlnet_model_paths"):
        thin_train.main(_argv("i2vgenxl", "--synthetic_data", "--pretrained_model_path",
                              str(tmp_path / "release"), "--DATA_PATH", str(tmp_path / "x")),
                        device="cpu")


def test_cli_refuses_the_dataset_path_and_a_missing_card(thin_train, tmp_path, monkeypatch):
    """The dataset path of a type whose network is not ported (here through
    ``--mixed_control_types_training``) is refused before anything is built;
    no card: refused."""
    monkeypatch.setattr(thin_train, "build_trainer", lambda *a, **k: pytest.fail("built"))
    for flags in (["--control_types", "normal"],
                  ["--mixed_control_types_training", "depth", "openpose"]):
        with pytest.raises(NotImplementedError, match="item 5"):
            thin_train.main(_argv("svd", "--DATA_PATH", str(tmp_path), *flags), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thin_train.main(_argv("svd", "--fake_weights", "--DATA_PATH", str(tmp_path)))


def _real_data(tmp_path, monkeypatch, model="svd", types=("depth",)):
    """Thin diffusers folders (one ControlNet per type), PNG-frame clips, and
    ``CTRL_ADAPTER_ANNOTATORS`` at a thin ``Intel/dpt-large``; returns the
    flags."""
    src = tc.thin_build_modules(argparse.Namespace(model_name=model,
                                                   control_types=list(types)), "cpu")
    flags = tc.train_flags(tc.write_thin_release(src, model, str(tmp_path / "release")))
    nets = (src.controlnet.nets if isinstance(src.controlnet, MultiControlNetModel)
            else [src.controlnet])
    if len(nets) < len(types):  # SVD's pipeline holds one: the others as copies
        extra = MultiControlNetModel([nets[0]] * len(types)).save_pretrained(
            str(tmp_path / "types"))
        i = flags.index("--controlnet_model_paths")
        flags = flags[:i + 1] + extra + flags[i + 2:]
    annotators = tc.write_annotators(str(tmp_path / "annotators"))
    monkeypatch.setenv("CTRL_ADAPTER_ANNOTATORS", json.dumps(annotators))
    clips, csv_path = tc.write_clips(str(tmp_path / "clips"))
    return [*flags, "--train_data_path", clips, "--train_prompt_path", csv_path,
            "--control_types", *types]


def _recording(monkeypatch):
    """Swap in a ``train_step`` that records each step's batch shapes and the
    ControlNet it ran."""
    seen = []
    step = CtrlAdapterTrainer.train_step

    def recorded(self, batch, *a, **k):
        seen.append(({k: tuple(v.shape) for k, v in batch.items()}, self.experts[0]))
        return step(self, batch, *a, **k)

    monkeypatch.setattr(CtrlAdapterTrainer, "train_step", recorded)
    return seen


def test_cli_trains_on_real_data(thin_train, tmp_path, monkeypatch):
    """Two steps of SVD depth on a folder of two PNG-frame clips: batches of
    frames, depth maps, SD-v1.5 and CLIP image embeddings from the fabricated
    towers; the log, a checkpoint, and validation on the step's batch with
    its ``_concat.gif``."""
    seen = _recording(monkeypatch)
    out = str(tmp_path / "out")
    run = thin_train.main(_argv("svd", "--skip_conv_in", "True", "--max_train_steps", "2",
                                "--checkpointing_steps", "2", "--run_validation",
                                "--validate_every_steps", "2", "--num_inference_steps", "2",
                                "--DATA_PATH", out, *_real_data(tmp_path, monkeypatch)),
                          device="cpu")
    assert [r["step"] for r in run.records] == [1, 2]
    assert all(math.isfinite(r["loss"]) for r in run.records)
    assert len(run.wait_s) == 2 and run.step_types == [None, None]
    with open(os.path.join(out, "train_log.jsonl")) as fh:
        assert [json.loads(line) for line in fh] == run.records
    assert run.checkpoints == [os.path.join(out, "checkpoint-2")]
    shapes = seen[0][0]
    assert shapes == {"frames": (1, tc.FRAMES, 64, 64, 3),
                      "controlnet_cond": (1, tc.FRAMES, 64, 64, 3),
                      "controlnet_text_emb": (1, 77, 768), "image_embeddings": (1, 1, 1024)}
    gif = os.path.join(out, "validation", "step_2.gif")
    assert run.validations == [gif]
    assert tc.frames_of(gif).shape == (tc.FRAMES, 64, 64, 3)
    assert tc.frames_of(gif.replace(".gif", "_concat.gif")).shape == (tc.FRAMES, 64, 128, 3)


def test_cli_swaps_the_mixed_type_tower(thin_train, tmp_path, monkeypatch):
    """``--mixed_control_types_training depth canny`` on real data: each step
    runs the resident ControlNet of its batch's type."""
    seen = _recording(monkeypatch)
    run = thin_train.main(_argv("svd", "--skip_conv_in", "True", "--max_train_steps", "4",
                                "--checkpointing_steps", "9", "--DATA_PATH",
                                str(tmp_path / "out"), "--mixed_control_types_training",
                                "depth", "canny",
                                *_real_data(tmp_path, monkeypatch, types=("depth", "canny"))),
                          device="cpu")
    types = [t[0] for t in run.step_types]
    assert set(types) == {"depth", "canny"} and len(types) == 4
    assert run.controlnet_by_type["depth"] is not run.controlnet_by_type["canny"]
    for ctype, (_, net) in zip(types, seen):
        assert net is run.controlnet_by_type[ctype]


BLOCKED = ("cv2", "imageio", "PIL", "yaml", "safetensors", "transformers", "wandb", "regex",
           "jax", "flax", "optax", "orbax", "ctrl_adapter_tpu")

_SUBPROCESS = """
import argparse, importlib.abc, io, json, os, sys, contextlib
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {{name}}")
sys.meta_path.insert(0, Block())
sys.path[:0] = [{repo!r}, {tests!r}]
import train_torch
import torch_cli_common as tc
train_torch.build_modules = tc.thin_train_modules
cfg = os.path.join({tmp!r}, "thin.yaml")
with open(cfg, "w") as fh:
    fh.write(open({yaml_src!r}).read().replace("height: 512", "height: 64")
             .replace("width: 512", "width: 64")
             .replace("n_sample_frames: 14", "n_sample_frames: 3")
             .replace("DATA_PATH: ./outputs", "DATA_PATH: " + os.path.join({tmp!r}, "o")))
err = io.StringIO()
with contextlib.redirect_stderr(err):
    run = train_torch.main(["--yaml_file", cfg, "--fake_weights", "--max_train_steps", "1",
                            "--mixed_precision", "no",
                            "--use_wandb", "--use_8bit_adam", "True", "--run_validation",
                            "--validate_every_steps", "1"], device="cpu")
assert "wandb unavailable" in err.getvalue() and "8-bit Adam" in err.getvalue(), err.getvalue()
assert len(run.records) == 1 and run.checkpoints and run.validations
clips, csv_path = tc.write_clips(os.path.join({tmp!r}, "clips"))
os.environ["CTRL_ADAPTER_ANNOTATORS"] = json.dumps(tc.write_annotators({tmp!r}))
src = tc.thin_build_modules(argparse.Namespace(model_name="svd", control_types=["depth"]), "cpu")
flags = tc.train_flags(tc.write_thin_release(src, "svd", os.path.join({tmp!r}, "release")))
real_cfg = os.path.join({tmp!r}, "real.yaml")
with open(real_cfg, "w") as fh:
    fh.write(open(cfg).read().replace("sample_data/videos", clips)
             .replace("sample_data/video_captions.csv", csv_path)
             .replace(os.path.join({tmp!r}, "o"), os.path.join({tmp!r}, "r")))
with contextlib.redirect_stderr(io.StringIO()):
    real = train_torch.main(["--yaml_file", real_cfg, "--max_train_steps", "1",
                             "--mixed_precision", "no", *flags], device="cpu")
assert len(real.records) == 1 and real.wait_s
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok", json.dumps(run.records[-1]["loss"]))
"""


def test_cli_runs_without_host_packages(tmp_path):
    code = _SUBPROCESS.format(blocked=BLOCKED, repo=REPO, tests=os.path.join(REPO, "tests"),
                              tmp=str(tmp_path),
                              yaml_src=os.path.join(REPO, "configs", "svd_train_depth.yaml"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("ok")
