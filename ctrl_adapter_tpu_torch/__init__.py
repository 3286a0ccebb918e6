"""PyTorch + CUDA port of ``ctrl_adapter_tpu`` for NVIDIA Hopper (sm_90a).

Layout mirrors the JAX package (``nn/``, ``ops/``, ``models/``, ``schedulers/``,
``pipelines/``, ``convert/``). Modules are ``torch.nn.Module`` s whose
``state_dict()`` keys are the diffusers names; activations are NCHW (NCFHW for
video). The three Pallas kernels on the SVD main path are hand-written CUDA
kernels under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).
This package never imports JAX.
"""
