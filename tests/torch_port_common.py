"""Helpers shared by the ``test_torch_*`` parity tests of the PyTorch port.

Both sides get the same inputs, made with numpy from a seed, and the same
weights: a JAX param tree is fabricated (``tests/utils.py:fake_init``) and moved
into the port module through ``ctrl_adapter_tpu_torch.convert.from_jax``. The
JAX package is NHWC, the port NCHW; these helpers transpose at the boundary.
"""

import numpy as np
import torch

from ctrl_adapter_tpu_torch.convert.from_jax import load_from_jax

torch.set_num_threads(1)


def nhwc_to_nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(x), -1, 1)))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x.detach().numpy(), 1, -1)


def port_config(cls, jax_config, **extra):
    """An instance of the port's config dataclass ``cls`` with the fields it
    shares with a JAX config, and ``extra``."""
    names = set(cls.__dataclass_fields__)
    return cls(**{k: v for k, v in vars(jax_config).items() if k in names}, **extra)


def port(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a JAX param tree into a port module (strict) and set eval mode."""
    return load_from_jax(module, params).eval()


def assert_close(got, want, atol, rtol=0.0, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    err = np.abs(got - want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=f"{what}: max abs err {err:.3e}")
