"""The port's I2VGen-XL training step with a trainable router against the JAX trainer.

The towers, weights, batch and draws of ``tests/test_torch_train_i2vgen.py``,
with three ControlNet experts (their own fabricated weights) and a router
whose fabricated gates (at their init's scale, 1 / sqrt(in_features)) train
in the same optimizer as the adapter: one global norm and one clip over
both, as optax does over the ``{"adapter", "router"}`` tree.
``expert_mask = [1, 0, 1]``: the masked expert's router weight and router
gradient must be exactly 0 (its logit loses 1e6 before an fp32 softmax,
which underflows to 0), the active ones' gradients nonzero. (With two
experts and one masked the softmax gives the other weight 1 and every
router gradient is 0: three keep the active gradients nonzero.)

Tier-1 runs the simple-weights router (one whole-step JAX compile); the
three conditional router types, whose input is the batch-mean timestep
sinusoid and/or CLIP image embedding, are marked slow. Tolerances as
``tests/test_torch_train_i2vgen.py`` states them; the router's weights in
the step's metrics within 1e-6 of JAX's (1e-4 for the routers that read
the timestep sinusoid, which differs from XLA's by up to 3e-5).
"""

import pytest

from .test_torch_train_i2vgen import _check


def _masked_router_is_exactly_zero(trainer, metrics):
    """The masked expert (1 of 3) has router weight 0 in every slot and a
    router gradient of exactly 0; the active ones a nonzero gradient."""
    assert (metrics["down_block_weights"][:, 1] == 0).all()
    assert (metrics["mid_block_weights"][1] == 0).all()
    n = len(trainer.names)
    grads = [p.grad for p in trainer.optimizer.params[n:]]
    assert len(grads) == 13 and all(g is not None for g in grads)
    assert all((g[1] == 0).all() for g in grads)
    assert all(g[e].abs().sum() > 0 for g in grads for e in (0, 2))


def test_i2vgenxl_router_train_step_matches_jax():
    """Three experts with a simple-weights router, expert 1 masked: the
    router's gradients and masters against JAX's, its weights in the
    metrics, and exactly 0 weight and gradient for the masked expert."""
    trainer, metrics = _check(num_experts=3, router_type="simple_weights")
    _masked_router_is_exactly_zero(trainer, metrics)


@pytest.mark.slow
@pytest.mark.parametrize("router_type", ["timestep_weights", "embedding_weights",
                                         "timestep_embedding_weights"])
def test_i2vgenxl_conditional_router_train_step_matches_jax(router_type):
    """The conditional routers take the batch-mean timestep sinusoid and/or
    CLIP image embedding as their input, as in JAX."""
    trainer, metrics = _check(num_experts=3, router_type=router_type)
    _masked_router_is_exactly_zero(trainer, metrics)
