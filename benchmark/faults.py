"""Faults planted underneath the timed path, for the tests that see the check
fail (``tests/test_bench_checks.py``) and for reading a fault on the card
(``control.py --fault``). Each is a context manager that patches the
program's classes, so a run built inside it carries the fault.

Generation: a scheduler step that returns its state unchanged; half of the
UNet's batch left out, its rows (the frames of each CFG half) past the middle
replaced by those before it (``half_batch``), or its conditional half by its
unconditional one (``cfg_half``); the video altered where the pipeline
produces it (its first frame inverted). Training: an optimizer step that
leaves the state unchanged; the loss taken over the first half of the frames
only (half of the batch's rows left out, the mean taken over the rest); the
largest leaf of each step's gradient zeroed before the optimizer gets it.
One chip holds each cell, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(*triples):
    """Set ``(owner, name, value)`` for the block, then restore."""
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in triples]
    try:
        for owner, name, value in triples:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def _pipelines():
    from ctrl_adapter_tpu_torch.pipelines.i2vgenxl import I2VGenXLControlNetAdapterPipeline
    from ctrl_adapter_tpu_torch.pipelines.svd import SVDControlNetAdapterPipeline

    return SVDControlNetAdapterPipeline, I2VGenXLControlNetAdapterPipeline


def state_unchanged():
    from ctrl_adapter_tpu_torch.schedulers.ddim import DDIMScheduler
    from ctrl_adapter_tpu_torch.schedulers.euler_discrete import EulerDiscreteScheduler

    same = staticmethod(lambda state, out, i, sample, *a, **k: sample.clone())
    return patched((EulerDiscreteScheduler, "step", same), (DDIMScheduler, "step", same))


def _unet_output(change):
    from ctrl_adapter_tpu_torch.models.unet_i2vgen import I2VGenXLUNet
    from ctrl_adapter_tpu_torch.models.unet_svd import UNetSpatioTemporalConditionModel

    def wrapped(forward):
        def run(self, *args, **kwargs):
            return change(forward(self, *args, **kwargs))
        return run

    return patched(*((cls, "forward", wrapped(cls.forward))
                     for cls in (UNetSpatioTemporalConditionModel, I2VGenXLUNet)))


def half_batch():
    """The UNet's (2b, f, ...) output: frames f/2.. replaced by frames ..f/2."""
    def change(out):
        f = out.shape[1] // 2
        out = out.clone()
        out[:, f:2 * f] = out[:, :f]
        return out
    return _unet_output(change)


def cfg_half():
    """The UNet's conditional half replaced by its unconditional half."""
    def change(out):
        b = out.shape[0] // 2
        return torch.cat([out[:b], out[:b]])
    return _unet_output(change)


def answer_altered():
    def altered(decode):
        def run(self, *args, **kwargs):
            video = decode(self, *args, **kwargs).clone()
            video[:, 0] = 1.0 - video[:, 0]
            return video
        return run

    return patched(*((cls, "_decode", altered(cls._decode)) for cls in _pipelines()))


def optimizer_unchanged():
    from ctrl_adapter_tpu_torch.train.trainer import MasterOptimizer

    return patched((MasterOptimizer, "step", lambda self, grads: False))


def half_frames():
    from ctrl_adapter_tpu_torch.train import trainer

    loss = trainer.edm_loss

    def first_half(pred, noisy, target, sigmas):
        f = pred.shape[1] // 2
        return loss(pred[:, :f], noisy[:, :f], target[:, :f], sigmas)

    return patched((trainer, "edm_loss", first_half))


def leaf_zeroed():
    from ctrl_adapter_tpu_torch.train.trainer import MasterOptimizer

    step = MasterOptimizer.step

    def run(self, grads):
        worst = max(range(len(grads)), key=lambda i: grads[i].float().norm().item())
        grads = list(grads)
        grads[worst] = torch.zeros_like(grads[worst])
        return step(self, grads)

    return patched((MasterOptimizer, "step", run))


FAULTS = {"generate": {"state_unchanged": state_unchanged, "half_batch": half_batch,
                       "cfg_half": cfg_half, "answer_altered": answer_altered},
          "train": {"state_unchanged": optimizer_unchanged, "half_frames": half_frames,
                    "leaf_zeroed": leaf_zeroed}}
