"""Weights on disk: the port's hand-written safetensors reader and writer, the
release loader and ``MultiControlNetModel.from_pretrained`` / ``save_pretrained``,
against the ``safetensors`` package and the JAX package.

- The reader returns exactly what the package returns (bf16, fp16, fp32,
  int64, a ``__metadata__`` entry, an unaligned buffer); the package reads the
  writer's files; a sharded index and a ``.bin`` are read.
- ``load_release`` is strict: a missing key, an unexpected key or a wrong shape
  raises, for thin ControlNet, adapter and router state dicts.
- On the same files, JAX's ``load_torch_release`` trees equal the port's loaded
  state dicts under ``convert/from_jax.py:jax_path``, exactly (fp32 files), as
  do the two packages' ``MultiControlNetModel.from_pretrained``.
"""

import json
import os

import numpy as np
import pytest
import torch

from ctrl_adapter_tpu.models.multicontrolnet import MultiControlNetModel as JMulti
from ctrl_adapter_tpu.train.checkpoints import load_torch_release
from ctrl_adapter_tpu_torch.convert.from_jax import _TO_TORCH, _flatten, jax_path
from ctrl_adapter_tpu_torch.convert.release import (
    load_release, read_safetensors, read_weights, save_release, write_safetensors)
from ctrl_adapter_tpu_torch.models.adapter import ControlNetAdapter
from ctrl_adapter_tpu_torch.models.controlnet import ControlNetModel
from ctrl_adapter_tpu_torch.models.multicontrolnet import MultiControlNetModel
from ctrl_adapter_tpu_torch.models.router import ControlNetRouter

import chip_smoke

from .torch_cli_common import CNET, THIN_CHANNELS

torch.set_num_threads(1)


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"w.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "w.fp16": torch.randn(7, generator=g).half(),
            "w.fp32": torch.randn(2, 3, 4, generator=g),
            "x.int64": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
            "z.scalar": torch.tensor(2.5)}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_reader_equals_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    path = str(tmp_path / "a.safetensors")
    save_file(_tensors(), path, metadata={"format": "pt", "note": "x"})
    _assert_same(read_safetensors(path), load_file(path))


def test_package_reads_the_writer(tmp_path):
    """Including an int64 buffer at an offset that is no multiple of 8 (after 3
    fp16 values), which the reader copies before viewing."""
    from safetensors import safe_open
    from safetensors.torch import load_file

    tensors = dict(_tensors(), **{"a.odd": torch.tensor([1.0, 2.0, 3.0]).half()})
    path = str(tmp_path / "b.safetensors")
    write_safetensors(tensors, path)
    with open(path, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n))
    assert n % 8 == 0 and header["__metadata__"] == {"format": "pt"}
    assert header["x.int64"]["data_offsets"][0] % 8 != 0
    _assert_same(load_file(path), tensors)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    _assert_same(read_safetensors(path), tensors)


def test_sharded_index_and_bin(tmp_path):
    tensors = _tensors()
    names = sorted(tensors)
    shards = {"m-1.safetensors": names[:2], "m-2.safetensors": names[2:]}
    (tmp_path / "sharded").mkdir()
    for shard, keys in shards.items():
        write_safetensors({k: tensors[k] for k in keys}, str(tmp_path / "sharded" / shard))
    with open(tmp_path / "sharded" / "diffusion_pytorch_model.safetensors.index.json", "w") as fh:
        json.dump({"weight_map": {k: s for s, ks in shards.items() for k in ks}}, fh)
    _assert_same(read_weights(str(tmp_path / "sharded")), tensors)
    (tmp_path / "bin").mkdir()
    torch.save(tensors, str(tmp_path / "bin" / "diffusion_pytorch_model.bin"))
    _assert_same(read_weights(str(tmp_path / "bin")), tensors)
    with pytest.raises(FileNotFoundError):
        read_weights(str(tmp_path))


def _thin(kind):
    torch.manual_seed(3)
    if kind == "controlnet":
        return ControlNetModel(CNET)
    if kind == "adapter":
        return ControlNetAdapter(
            backbone_model_name="svd", num_blocks=1, num_adapters_per_location=3,
            cross_attention_dim=32, adapter_locations=("A", "B", "C", "D", "M"),
            add_temporal_resnet=True, add_temporal_transformer=True,
            custom_down_block_channels=THIN_CHANNELS, custom_mid_block_channels=64,
            attention_head_dim=16)
    router = ControlNetRouter(num_experts=7)
    with torch.no_grad():
        for p in router.parameters():
            p.normal_()
    return router


KINDS = ("controlnet", "adapter", "router")


@pytest.mark.parametrize("kind", KINDS)
def test_release_loads_strictly_and_equals_jax(kind, tmp_path):
    """The written state dict comes back exactly (fp16 storage cast back into
    fp32 too), JAX's tree of the same file equals it leaf by leaf, and a
    missing key, an unexpected key and a wrong shape each raise."""
    src = _thin(kind)
    state = src.state_dict()
    path = str(tmp_path / kind)
    save_release(state, path, config={"kind": kind})
    dst = _thin(kind)
    with torch.no_grad():
        for p in dst.parameters():
            p.zero_()
    assert load_release(dst, path) == {"kind": kind}
    _assert_same(dst.state_dict(), state)

    tree, config = load_torch_release(path)
    assert config == {"kind": kind}
    flat = _flatten(tree["params"])
    want = {}
    for name, t in state.items():
        arr = t.numpy()
        want[jax_path(name, t.dim())] = (arr.transpose(np.argsort(_TO_TORCH[arr.ndim]))
                                         if jax_path(name, t.dim())[-1] == "kernel" else arr)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg="/".join(k))

    half = str(tmp_path / "half")
    save_release({k: v.half() for k, v in state.items()}, half)
    load_release(dst, half)
    _assert_same(dst.state_dict(), {k: v.half().float() for k, v in state.items()})

    name = sorted(state)[0]
    for label, bad in (("missing", {k: v for k, v in state.items() if k != name}),
                       ("unexpected", dict(state, stray=torch.zeros(2))),
                       ("shape", dict(state, **{name: torch.zeros(*state[name].shape, 2)}))):
        save_release(bad, str(tmp_path / label))
        with pytest.raises(RuntimeError):
            load_release(_thin(kind), str(tmp_path / label))


def test_multicontrolnet_pretrained_round_trip_and_jax(tmp_path):
    nets = [ControlNetModel(CNET) for _ in range(2)]
    for i, net in enumerate(nets):
        chip_smoke.random_fill(net, i)
    MultiControlNetModel(nets).save_pretrained(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["controlnet", "controlnet_1"]
    back = MultiControlNetModel.from_pretrained(str(tmp_path), CNET)
    assert back.num_experts == 2
    jmulti = JMulti.from_pretrained(str(tmp_path))
    for net, loaded, jparams in zip(nets, back.nets, jmulti.params_per_expert):
        _assert_same(loaded.state_dict(), net.state_dict())
        flat = _flatten(jparams["params"])
        for name, t in net.state_dict().items():
            arr = t.numpy()
            if arr.ndim in _TO_TORCH and name.endswith(".weight"):
                arr = arr.transpose(np.argsort(_TO_TORCH[arr.ndim]))
            np.testing.assert_array_equal(flat[jax_path(name, t.dim())], arr, err_msg=name)
    with pytest.raises(FileNotFoundError):
        MultiControlNetModel.from_pretrained(str(tmp_path / "none"))
