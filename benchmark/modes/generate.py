"""The ``generate`` mode: one client generating whole clips back to back.

Set-up builds the family's pipeline at the configuration's widths with weights
drawn from the seed, and warms every shape up with a short ``generate`` (one
controlled step, one UNet-only step and the decode). The window then calls
``generate`` at the published settings on fresh inputs, clip after clip, each
video read back to the host; a clip starts only while the previous clip's time
still fits in the window, and there is always one.

The check: one clip, drawn from the seed among those finished (reservoir
sampling), keeps its inputs, the state before and after its first step, one
controlled step and one UNet-only step (drawn from the seed), that controlled
step's adapter outputs, the UNet's outputs of the three steps, the latents the
decode took and the video read back. The first step, at the largest noise, is
where the conditioning moves the UNet's output most. Once the window has
closed and the program is freed, the float32 reference rebuilds the towers
from the seed and recomputes each of these from the program's own state
(``compare.py`` gives the numbers, ``limits/<cell>.json`` their limits).

With ``--trace 1`` the window also times the towers with CUDA events (forward
hooks on the UNet, the ControlNet and the adapter, and the decode), and after
it a short segment runs under the profiler: ``generate`` at ``profile_steps``
steps without the decode, then the decode, weighted to a clip's step counts;
each part traced three times, the third with the program's spans recorded
(``harness/profile.py``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from harness import compare, flops, profile, seeds
from harness.manifest import check_traffic, kernel_ops
from harness.peaks import BF16_FLOPS
from reference.svd_pipeline import control_window


TRAFFIC = ("warmup_steps", "profile_steps")  # the traffic mix's settings this mode reads


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def control_steps(g: dict, steps: Optional[int] = None):
    """(the controlled steps' [lo, hi) window, the steps) of a clip at
    ``steps`` steps (the configuration's by default)."""
    steps = steps or g["num_inference_steps"]
    return control_window(steps, g["control_guidance_start"], g["control_guidance_end"]), steps


class Capture:
    """The hooks that keep one sampled clip's states and outputs (module doc).

    What they keep goes into buffers that the warm-up allocates (``prime``)
    and later clips overwrite, so the window's peak memory holds them on
    every seed, whichever step and clip the seed samples."""

    def __init__(self, pipe, rng, window, steps):
        (lo, hi), n = window, steps
        self.pipe, self.rng = pipe, rng
        self.i_ctrl = rng.randrange(lo, hi)
        self.i_unet = rng.randrange(hi, n) if hi < n else rng.randrange(0, lo)
        self.roles = {}  # step index -> its roles ("first", "ctrl", "only") in the kept clip
        self.active, self.step_index, self.kept = False, 0, {}
        self.sample = None  # (clip, inputs, video)
        self.handles = [pipe.adapter.register_forward_hook(self._adapter),
                        pipe.unet.register_forward_hook(self._unet)]
        self._step, self._decode, self._vae = pipe.scheduler.step, pipe._decode, pipe.vae.decode
        pipe.scheduler.step = self._wrapped_step
        pipe._decode = self._wrapped_decode
        pipe.vae.decode = self._wrapped_vae

    def close(self) -> None:
        for h in self.handles:
            h.remove()
        self.pipe.scheduler.step, self.pipe._decode = self._step, self._decode
        del self.pipe.vae.decode
        self.pipe = None

    def prime(self, window):
        """Keep the warm-up's first controlled and UNet-only steps, to
        allocate the buffers."""
        self.roles = self._roles(*window)
        self.active, self.step_index = True, 0

    @staticmethod
    def _roles(ctrl: int, only: int) -> dict:
        roles = {0: ["first"]}
        roles.setdefault(ctrl, []).append("ctrl")
        roles.setdefault(only, []).append("only")
        return roles

    def begin(self, clip: int) -> None:
        self.roles = self._roles(self.i_ctrl, self.i_unet)
        self.active = self.rng.random() < 1.0 / (clip + 1)  # replaces the kept clip
        self.step_index = 0

    def end(self, clip: int, inputs: dict, video: torch.Tensor) -> None:
        if self.active:
            self.sample = (clip, inputs, video)
        self.active = False

    def _keep(self, key: str, t: torch.Tensor) -> None:
        buf = self.kept.get(key)
        if buf is not None and buf.shape == t.shape and buf.dtype == t.dtype:
            buf.copy_(t)
        else:
            self.kept[key] = t.clone()

    def _adapter(self, _module, _args, out):
        if self.active and "ctrl" in self.roles.get(self.step_index, ()):
            down, mid = out
            outs = list(down) + ([] if mid is None else [mid])
            for k, t in enumerate(outs):
                self._keep(f"adapter{k}", t)
            self.kept["adapter_n"] = len(outs)

    def _unet(self, _module, _args, out):
        for role in self.roles.get(self.step_index, ()) if self.active else ():
            self._keep(f"unet_{role}", out)

    def _wrapped_step(self, state, model_output, step_index, sample, *args, **kwargs):
        out = self._step(state, model_output, step_index, sample, *args, **kwargs)
        for role in self.roles.get(step_index, ()) if self.active else ():
            self._keep(f"state_{role}", sample)
            self._keep(f"next_{role}", out)
        self.step_index = step_index + 1
        return out

    def _wrapped_decode(self, latents, *args, **kwargs):
        if self.active:
            self._keep("decode", latents)
            self.kept["raw_n"] = 0
        return self._decode(latents, *args, **kwargs)

    def _wrapped_vae(self, *args, **kwargs):
        out = self._vae(*args, **kwargs)
        if self.active:
            self._keep(f"raw{self.kept['raw_n']}", out)
            self.kept["raw_n"] += 1
        return out

    def held(self, name: str) -> list:
        """The kept list ``adapter`` or ``raw``, in order."""
        return [self.kept[f"{name}{k}"] for k in range(self.kept[f"{name}_n"])]


class TowerTimer:
    """CUDA events around each call of the towers and of the decode."""

    def __init__(self, pipe):
        self.events: Dict[str, List[list]] = {}
        self.handles = []
        for name in ("unet", "controlnet", "adapter"):
            module = getattr(pipe, name)
            self.handles += [module.register_forward_pre_hook(self._pre(name)),
                             module.register_forward_hook(self._post(name))]
        self.pipe, self._decode = pipe, pipe._decode
        pipe._decode = self._timed_decode

    def _record(self, name, end):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if end:
            self.events[name][-1][1] = ev
        else:
            self.events.setdefault(name, []).append([ev, None])

    def _pre(self, name):
        return lambda *_: self._record(name, False)

    def _post(self, name):
        return lambda *_: self._record(name, True)

    def _timed_decode(self, *args, **kwargs):
        self._record("decode", False)
        out = self._decode(*args, **kwargs)
        self._record("decode", True)
        return out

    def close(self) -> Dict[str, List[float]]:
        for h in self.handles:
            h.remove()
        self.pipe._decode = self._decode
        self.pipe = None
        torch.cuda.synchronize()
        return {name: [a.elapsed_time(b) for a, b in evs] for name, evs in self.events.items()}


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float, log=print,
        control=None, group=None) -> dict:
    """One run of the cell; with ``control`` (``control.py``), also the
    control's numbers under ``control``. One client on one card: no
    ``group``."""
    if group is not None:
        raise ValueError("the generate mode runs on one card")
    fam = cell.family()
    cfg, traffic = cell.config, cell.traffic
    check_traffic(traffic, TRAFFIC)
    g = cfg["generate"]
    kw = fam.generate_kwargs(cfg)
    window, steps = control_steps(g)
    frames = fam.frames_per_clip(cfg)

    pipe, n_params = fam.build(cfg, dev, seed)
    capture = Capture(pipe, seeds.rng(seed, "check"), window, steps)
    warm = dict(kw, num_inference_steps=traffic["warmup_steps"])
    warm_window = control_steps(g, warm["num_inference_steps"])[0]
    if warm_window == (0, 0) or warm_window[1] >= warm["num_inference_steps"]:
        raise ValueError("the warm-up must run a controlled and a UNet-only step")
    capture.prime(warm_window)
    pipe.generate(**fam.inputs(cfg, dev, seeds.generator(dev, seed, "warmup")), **warm).cpu()
    capture.active = False
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    held = sum(t.numel() * t.element_size() for t in capture.kept.values() if torch.is_tensor(t))
    log(f"set-up {setup_s:.3f} s ({n_params} parameters); the check's buffers {held} bytes")

    timer = TowerTimer(pipe) if trace else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    clips, last = 0, 0.0
    _sync(dev)
    t0 = time.perf_counter()
    while clips == 0 or (time.perf_counter() - t0) + last <= seconds:
        inputs = fam.inputs(cfg, dev, seeds.generator(dev, seed, "clip", clips))
        capture.begin(clips)
        c0 = time.perf_counter()
        video = pipe.generate(**inputs, **kw).cpu()
        last = time.perf_counter() - c0
        capture.end(clips, inputs, video)
        clips += 1
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    capture.close()
    record = {"window_s": window_s, "clips": clips, "frames": clips * frames,
              "tower_ms": timer.close() if timer else {}}
    log(f"window {window_s:.3f} s, {clips} clips, {clips * frames} frames, "
        f"peak {peak} bytes")

    segment = None
    if trace:
        segment = profile_clip(fam, pipe, cfg, traffic, dev, seed, log)
        record["segment"] = segment
        record["spans"] = segment.spans if segment is not None else None
        record["clip_flops"] = flops.clip_flops(fam, cfg, window, steps)
        record["peak_flops"] = BF16_FLOPS
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = check(fam, cfg, dev, seed, capture)
    ok, checks = compare.judge(numbers, cell.limits())
    log(f"check {time.perf_counter() - t_check:.1f} s on clip {capture.sample[0]}, steps "
        f"{capture.i_ctrl} and {capture.i_unet}")

    result = {"correct": ok, "attempted": clips, "failed": 0 if ok else 1}
    if trace:
        result["metrics"] = read_metrics(cell, record)
    else:
        e2e = {"frames_per_s": clips * frames / window_s, "peak_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = device_info(dev, cell.chips, peak)
    if trace and segment is not None:
        result["device"].update(busy_s=segment.busy_s, window_s=segment.span_s)
        result["breakdown"] = {"device_ops": profile.top(segment.device_ops),
                               "idle_gaps": profile.top(segment.idle_gaps)}
    if control is not None:
        result["control"] = check(fam, cfg, dev, seed, capture, control)
    result["checks"] = checks
    return result


def read_metrics(cell, record: dict) -> dict:
    """The cell's per-layer metrics that their readers find in ``record``."""
    out = {}
    for m, reader in zip(cell.per_layer, cell.readers().values()):
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def profile_clip(fam, pipe, cfg, traffic, dev, seed, log) -> Optional[profile.Segment]:
    """The profiled segment, weighted to one clip: ``profile_steps`` steps must
    hold controlled and UNet-only steps in the clip's ratio."""
    g = cfg["generate"]
    (lo, hi), steps = control_steps(g)
    (plo, phi), psteps = control_steps(g, traffic["profile_steps"])
    w = (hi - lo) / (phi - plo)
    if (steps - (hi - lo)) != w * (psteps - (phi - plo)):
        raise ValueError(f"profile_steps={psteps} does not hold the clip's ratio of "
                         f"controlled to UNet-only steps")
    ops = kernel_ops()
    inputs = fam.inputs(cfg, dev, seeds.generator(dev, seed, "profile"))
    kw = dict(fam.generate_kwargs(cfg), num_inference_steps=psteps, output_type="latent")
    parts = []
    for run in (lambda: pipe.generate(**inputs, **kw),
                lambda: fam.decode(pipe, parts[0][0].result, cfg)):
        timed = profile.trace(run, ops, log=log)
        named = profile.trace(run, ops, host=True, log=log)
        spanned = profile.trace(run, ops, log=log, spans=True)
        if timed is None or named is None or spanned is None:
            return None
        timed.idle_gaps = profile.named_gaps(timed, named)
        timed.spans = spanned.spans
        parts.append((timed, named))
    (sample, _), (decode, _) = parts
    log(f"profile: {w:g} x ({psteps} steps: busy {sample.busy_s:.4f} s of {sample.span_s:.4f} s)"
        f" + decode (busy {decode.busy_s:.4f} s of {decode.span_s:.4f} s); kernel calls "
        f"{sample.kernel_calls}")
    return sample.scaled(w) + decode


@torch.no_grad()
def check(fam, cfg, dev, seed: int, capture: Capture, control=None) -> Dict[str, float]:
    """The numbers of ``compare.py`` for the sampled clip, the reference in
    float32 with TF32 off. With ``control`` (a function that turns the
    reference towers into the control), the control's outputs from the same
    states take the program's place."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _check(fam, cfg, dev, seed, capture, control)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _check(fam, cfg, dev, seed, capture, control):
    clip, inputs, video = capture.sample
    kept = dict(capture.kept)
    towers = fam.reference_towers(cfg, dev, seed)
    smp = fam.sampler(towers, inputs, cfg)
    steps = {"first": 0, "ctrl": capture.i_ctrl, "only": capture.i_unet}
    states = {r: kept[f"state_{r}"].float() for r in steps}
    ref = {r: smp.step(states[r], i) for r, i in steps.items()}
    ref_raw = smp.decode_raw(kept["decode"])
    n = ref_raw.shape[0]  # a program may pad the frames to its decode chunk
    got = {"adapter": capture.held("adapter"), "raw": torch.cat(capture.held("raw"))[:n],
           **{f"unet_{r}": kept[f"unet_{r}"] for r in steps}}
    if control is not None:
        control(towers)
        for r, i in steps.items():
            out = smp.step(states[r], i)
            got[f"unet_{r}"] = out["unet"]
            if r == "ctrl":
                got["adapter"] = out["adapter"]
            kept[f"next_{r}"] = smp.update(states[r], out["unet"], i)
        got["raw"] = smp.decode_raw(kept["decode"])
        video = smp.finish(got["raw"], video.shape[0]).to(video.dtype).cpu()

    def gap(a, b):
        return (a.float() - b.float().to(a.device)).abs().max().item()

    return {
        # exact: the first state from the drawn noise, the guidance and scheduler
        # update from the program's own UNet output, the video from its decoder output
        "start": gap(kept["state_first"], smp.start(inputs["latents"])),
        "step": max(gap(kept[f"next_{r}"], smp.update(states[r], got[f"unet_{r}"], i))
                    for r, i in steps.items()),
        "video": gap(video, smp.finish(got["raw"].float(), video.shape[0]).to(video.dtype)),
        # the towers against the float32 reference from the same state
        "adapter": compare.worst_rel(got["adapter"], ref["ctrl"]["adapter"]),
        "unet_controlled": compare.rel(got["unet_ctrl"], ref["ctrl"]["unet"]),
        "unet_only": compare.rel(got["unet_only"], ref["only"]["unet"]),
        "unet_first": compare.rel(got["unet_first"], ref["first"]["unet"]),
        "decode": compare.rel(got["raw"], ref_raw)}


def device_info(dev, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": peak}
