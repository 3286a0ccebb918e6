"""Data-parallel training of ``train_torch.py`` over two CPU processes (gloo).

The counterpart of the JAX package's multi-device training test
(``tests/test_train_step.py`` on ``parallel/mesh.py``): two processes, each
started as ``torchrun`` would start it (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and running
``train_torch.main(argv + ["--multihost"], device="cpu")`` at thin widths, for
SVD and for I2VGen-XL with 3 ControlNets and a simple-weights router (there
under ``gradient_accumulation_steps`` 2), 2 steps with ``--scale_lr``:

- after each step both processes hold the same masters, to the bit (and
  under accumulation the same accumulated gradient), and log the same
  records;
- they equal, to the bit, one process that runs each step's two halves of
  the global batch apart and averages their gradients (``(a + b) / 2``, what
  the all-reduce computes);
- I2VGen-XL: they equal one process over the doubled batch
  (``--train_batch_size 2`` at twice the learning rate) within 1e-2 lr plus
  1e-6 relative, summation order only. The thin steps' gradients lie near
  Adam's eps (``tests/test_torch_train_step.py``), where an update
  lr * g / (|g| + eps) turns a relative error of g into an absolute one of up
  to lr, so the masters are held in units of lr. SVD at batch 2 is another
  computation: its temporal transformers pair each row with another video's
  single-key context (ROADMAP Queue 3), and conditioning dropout gives the
  two videos different contexts; each process at batch 1, as the
  reference's DDP runs, has no such pairing;
- ``--scale_lr`` doubles the learning rate in the log.

Each pair of processes has 60 s; they and this process run one thread each.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import train_torch
from ctrl_adapter_tpu_torch.parallel import mesh as parallel
from ctrl_adapter_tpu_torch.train import init as tinit

from . import torch_cli_common as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 5e-5
CASES = {
    "svd": ["--model_name", "svd", "--skip_conv_in", "True"],
    "i2vgenxl-router": ["--model_name", "i2vgenxl", "--control_types", "depth", "canny",
                        "normal", "--multi_source_random_select_control_types", "True",
                        "--max_num_multi_source_train", "2",
                        "--gradient_accumulation_steps", "2"],
}

_RANK = """
import sys, torch
sys.path[:0] = [{repo!r}, {tests!r}]
import train_torch
import torch_cli_common as tc
from ctrl_adapter_tpu_torch.train.trainer import CtrlAdapterTrainer
train_torch.build_modules = tc.thin_train_modules
snapshots, step = [], CtrlAdapterTrainer.train_step

def recording(self, *args, **kwargs):
    out = step(self, *args, **kwargs)
    acc = self.optimizer.acc_grads
    snapshots.append((torch.cat([m.reshape(-1) for m in self.optimizer.masters]),
                      None if acc is None else torch.cat([a.reshape(-1) for a in acc])))
    return out

CtrlAdapterTrainer.train_step = recording
run = train_torch.main({argv!r}, device="cpu")
torch.save({{"snapshots": snapshots, "records": run.records, "world": run.mesh.world_size,
             "rank": run.mesh.rank}}, {out!r})
"""


def _argv(flags, data, *extra):
    return [*flags, "--height", "64", "--width", "64", "--n_sample_frames", str(tc.FRAMES),
            "--mixed_precision", "no", "--fake_weights", "--max_train_steps", "2",
            "--checkpointing_steps", "100", "--save_starting_step", "100", "--seed", "11",
            "--DATA_PATH", data, *extra]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", list(CASES))
def test_two_gloo_ranks_train_as_one_process(case, tmp_path, monkeypatch):
    argv = _argv(CASES[case], str(tmp_path / "ddp"), "--scale_lr", "True", "--multihost")
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1")
    procs = []
    for rank in range(2):
        code = _RANK.format(repo=REPO, tests=os.path.join(REPO, "tests"), argv=argv,
                            out=str(tmp_path / f"rank{rank}.pt"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank))))
    threads = torch.get_num_threads()
    try:  # the references in this process while the two ranks run
        torch.set_num_threads(1)
        monkeypatch.setattr(train_torch, "build_modules", tc.thin_train_modules)
        halves = _halves(_argv(CASES[case], str(tmp_path / "h"), "--learning_rate", str(2 * LR)))
        one = None if case == "svd" else train_torch.main(
            _argv(CASES[case], str(tmp_path / "one"), "--train_batch_size", "2",
                  "--learning_rate", str(2 * LR)), device="cpu")
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    for (m0, a0), (m1, a1) in zip(ranks[0]["snapshots"], ranks[1]["snapshots"]):
        assert torch.equal(m0, m1)
        assert (a0 is None) == (a1 is None) and (a0 is None or torch.equal(a0, a1))
    assert len(ranks[0]["snapshots"]) == 2
    same = [[{k: v for k, v in rec.items() if k != "loss_time"} for rec in r["records"]]
            for r in ranks]
    assert same[0] == same[1]  # the logged loss and weights: the mean over the processes
    assert [r["lr"] for r in ranks[0]["records"]] == [2 * LR, 2 * LR]

    ddp = ranks[0]["snapshots"][-1][0]
    assert torch.equal(ddp, halves)
    if one is None:
        return
    masters = torch.cat([m.reshape(-1) for m in one.trainer.optimizer.masters])
    np.testing.assert_allclose(ddp.numpy(), masters.numpy(), rtol=1e-6, atol=1e-2 * 2 * LR)
    assert one.trainer.optimizer.update_count == 1
    for a, b in zip(ranks[0]["records"], one.records):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)


def _halves(argv):
    """The masters after the run of ``argv`` in one process that computes each
    step's gradient on the two halves of the global batch (and its draws)
    apart and averages them."""
    args = train_torch.parse_args(argv)
    trainer = train_torch.build_trainer(args, torch.device("cpu"))
    train_torch.fabricate_frozen(trainer, args.seed)
    tinit.init_trainable(trainer, torch.Generator().manual_seed(args.seed))
    params, f = trainer.optimizer.params, args.n_sample_frames
    for step in range(1, args.max_train_steps + 1):
        raw, sparse, seed = train_torch.step_inputs(args, trainer.config, step, 2, f)
        draws = trainer.draw(torch.Generator().manual_seed(seed), 2, f, 8, 8)
        halves = []
        for rank in range(2):
            mesh = parallel.Mesh(rank=rank, world_size=2)
            for p in params:
                p.grad = None
            trainer.loss(train_torch.shard_step(mesh, raw), parallel.shard_batch(mesh, draws),
                         sparse).backward()
            halves.append([torch.zeros_like(p) if p.grad is None else p.grad.float()
                           for p in params])
        trainer.optimizer.step([(a + b) / 2 for a, b in zip(*halves)])
    return torch.cat([m.reshape(-1) for m in trainer.optimizer.masters])
