"""OpenPose body pose: ``BodyPoseNet`` (``body_pose_model.pth``), the part
affinity decoding, the skeleton drawing and the estimator
``OpenposeDetector``.

Counterpart of ``ctrl_adapter_tpu/conditions/openpose.py`` (pytorch-openpose
``Body`` / ``draw_bodypose`` at one scale: box 368, stride 8, thresholds
0.1 / 0.05). The CMU network runs fp32 on the device: a VGG19 stem
(conv1_1 .. conv4_4_CPM, 128 channels at stride 8) and six two-branch stages
(PAF 38 channels, heatmap 19), stages 2-6 on ``concat(paf, heat, features)``
through 7x7 convs, BGR input in ``pixel / 256 - 0.5``. The frame is resized
(uint8 cubic, factor ``0.5 * 368 / h``) and padded with 128 to a multiple of
8; both maps are resized x8, cropped and resized to the frame (float32
cubic), all with ``ops/resize.py:resize_cubic``. The peak search's blur and its
4-neighbour test run on the device; the pair scoring, the greedy assembly
and the drawing (``imgproc``'s rasterisers, on the host) keep the JAX
functions' semantics to the letter: the score order (a stable sort), the
``0.5 h / norm - 1`` prior, the prune (at least 4 parts, a mean score of at
least 0.4) and the ``k < 17`` rule.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_cubic
from .imgproc import add_weighted, as_batches, circle, ellipse2poly, fill_convex_poly, \
    gaussian_blur

STEM = (  # (name, out_channels, pool_before)
    ("conv1_1", 64, False), ("conv1_2", 64, False),
    ("conv2_1", 128, True), ("conv2_2", 128, False),
    ("conv3_1", 256, True), ("conv3_2", 256, False), ("conv3_3", 256, False),
    ("conv3_4", 256, False),
    ("conv4_1", 512, True), ("conv4_2", 512, False),
    ("conv4_3_CPM", 256, False), ("conv4_4_CPM", 128, False),
)
BRANCHES = (("L1", 38), ("L2", 19))


def _layers() -> List[Tuple[str, int, int, int]]:
    """(caffe name, in, out, kernel) of every conv of the body network."""
    out, cin = [], 3
    for name, ch, _ in STEM:
        out.append((name, cin, ch, 3))
        cin = ch
    for br, ch in BRANCHES:
        out += [(f"conv5_{i}_CPM_{br}", 128, 128, 3) for i in (1, 2, 3)]
        out += [(f"conv5_4_CPM_{br}", 128, 512, 1), (f"conv5_5_CPM_{br}", 512, ch, 1)]
        for s in range(2, 7):
            out.append((f"Mconv1_stage{s}_{br}", 128 + 38 + 19, 128, 7))
            out += [(f"Mconv{i}_stage{s}_{br}", 128, 128, 7) for i in range(2, 6)]
            out += [(f"Mconv6_stage{s}_{br}", 128, 128, 1), (f"Mconv7_stage{s}_{br}", 128, ch, 1)]
    return out


class BodyPoseNet(nn.Module):
    """(b, 3, H, W) BGR in [-0.5, 0.5] -> (paf (b, 38, H/8, W/8), heatmap
    (b, 19, H/8, W/8)); the convs keyed by their caffe names."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleDict({
            name: nn.Conv2d(cin, cout, k, padding=k // 2, device=device, dtype=dtype)
            for name, cin, cout, k in _layers()})

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        conv = self.layers
        for name, _, pool in STEM:
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(conv[name](x))
        feat = x
        outs = []
        for br, _ in BRANCHES:
            h = feat
            for i in (1, 2, 3, 4):
                h = F.relu(conv[f"conv5_{i}_CPM_{br}"](h))
            outs.append(conv[f"conv5_5_CPM_{br}"](h))
        paf, heat = outs
        for s in range(2, 7):
            h = torch.cat([paf, heat, feat], dim=1)
            outs = []
            for br, _ in BRANCHES:
                y = h
                for i in range(1, 7):
                    y = F.relu(conv[f"Mconv{i}_stage{s}_{br}"](y))
                outs.append(conv[f"Mconv7_stage{s}_{br}"](y))
            paf, heat = outs
        return paf, heat


def openpose_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``body_pose_model.pth`` in the caffe export's layout (``conv1_1.weight``)
    or pytorch-openpose's (``model0.conv1_1.weight``) -> ``BodyPoseNet``'s
    state dict; the layer names are unique either way. A name that is no
    layer raises ``KeyError``; ``load_state_dict(strict=True)`` finds the
    missing ones."""
    names = {name for name, *_ in _layers()}
    out = {}
    for key, v in sd.items():
        parts = key.split(".")
        if len(parts) < 2 or parts[-2] not in names or parts[-1] not in ("weight", "bias"):
            raise KeyError(f"unexpected openpose checkpoint entry: {key}")
        out[f"layers.{parts[-2]}.{parts[-1]}"] = torch.as_tensor(v).to(torch.float32)
    return out


# ------------------------------------------------------ PAF decoding (host)
# limb k joins keypoints LIMB_SEQ[k] (1-indexed); its field lies in paf
# channels MAP_IDX[k] - 19
LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [3, 17], [6, 18]]
MAP_IDX = [[31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44], [19, 20],
           [21, 22], [23, 24], [25, 26], [27, 28], [29, 30], [47, 48], [49, 50],
           [53, 54], [51, 52], [55, 56], [37, 38], [45, 46]]
COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
          [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
          [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
          [255, 0, 255], [255, 0, 170], [255, 0, 85]]


def peak_masks(heat: torch.Tensor, thre1: float = 0.1) -> torch.Tensor:
    """(..., h, w, 19) heatmaps -> (..., 18, h, w) bool: per part, the pixels
    of the sigma-3 blur that are at least their four neighbours (0 beyond
    the border) and above ``thre1``."""
    m = gaussian_blur(heat[..., :18].movedim(-1, -3).contiguous(), 3.0)
    zero_row = torch.zeros_like(m[..., :1, :])
    zero_col = torch.zeros_like(m[..., :1])
    up = torch.cat([zero_row, m[..., :-1, :]], dim=-2)
    down = torch.cat([m[..., 1:, :], zero_row], dim=-2)
    left = torch.cat([zero_col, m[..., :-1]], dim=-1)
    right = torch.cat([m[..., 1:], zero_col], dim=-1)
    return (m >= up) & (m >= down) & (m >= left) & (m >= right) & (m > thre1)


def find_peaks(heatmap, thre1: float = 0.1, masks=None) -> List[List[Tuple]]:
    """Per part, (x, y, score, peak id) of each peak of ``peak_masks`` in
    row-major order, ids increasing over the parts; ``heatmap`` (h, w, 19)
    a tensor on any device or an array, ``masks`` its ``peak_masks`` if
    already made."""
    heat = torch.as_tensor(heatmap)
    if masks is None:
        masks = peak_masks(heat, thre1)
    nz = masks.nonzero()  # (part, y, x), part-major, then row-major
    scores = heat[nz[:, 1], nz[:, 2], nz[:, 0]].cpu().numpy()
    idx = nz.cpu().numpy()
    all_peaks: List[List[Tuple]] = [[] for _ in range(18)]
    for i, ((part, y, x), s) in enumerate(zip(idx, scores)):
        all_peaks[int(part)].append((int(x), int(y), float(s), i))
    return all_peaks


def score_connections(paf, all_peaks, ori_h: int, thre2: float = 0.05) -> List[np.ndarray]:
    """Per limb, (idA, idB, score, iA, iB) of the pairs kept: every candidate
    pair scored by the mean PAF along 10 points plus the distance prior,
    then taken greedily by score. ``paf`` (h, w, 38) is read on the host,
    and only when some limb has candidates at both ends."""
    connection_all = []
    host = None
    for k, (ia, ib) in enumerate(LIMB_SEQ):
        candA, candB = all_peaks[ia - 1], all_peaks[ib - 1]
        if not candA or not candB:
            connection_all.append(np.zeros((0, 5)))
            continue
        if host is None:
            host = torch.as_tensor(paf).cpu().numpy()
        score_mid = host[:, :, [i - 19 for i in MAP_IDX[k]]]
        candidates = []
        for i, a in enumerate(candA):
            for j, b in enumerate(candB):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float32)
                norm = max(math.sqrt(float(vec @ vec)), 1e-8)
                vecn = vec / norm
                xs = np.linspace(a[0], b[0], 10)
                ys = np.linspace(a[1], b[1], 10)
                pts = score_mid[np.round(ys).astype(int).clip(0, host.shape[0] - 1),
                                np.round(xs).astype(int).clip(0, host.shape[1] - 1)]
                score_midpts = pts @ vecn
                prior = float(score_midpts.mean()) + min(0.5 * ori_h / norm - 1, 0)
                if (np.count_nonzero(score_midpts > thre2) > 0.8 * len(score_midpts)
                        and prior > 0):
                    candidates.append((i, j, prior, prior + a[2] + b[2]))
        candidates.sort(key=lambda c: c[2], reverse=True)
        connection = np.zeros((0, 5))
        used_a, used_b = set(), set()
        for i, j, s, _ in candidates:
            if i not in used_a and j not in used_b:
                connection = np.vstack([connection, [candA[i][3], candB[j][3], s, i, j]])
                used_a.add(i)
                used_b.add(j)
                if len(connection) >= min(len(candA), len(candB)):
                    break
        connection_all.append(connection)
    return connection_all


def assemble_subsets(all_peaks, connection_all) -> Tuple[np.ndarray, np.ndarray]:
    """Limb connections merged into people: rows of 18 peak ids, the total
    score and the part count; people with fewer than 4 parts or a mean score
    under 0.4 pruned."""
    candidate = np.array([p for peaks in all_peaks for p in peaks], np.float32).reshape(-1, 4)
    subset = -1 * np.ones((0, 20))
    for k in range(len(MAP_IDX)):
        if connection_all[k].shape[0] == 0:
            continue
        partAs = connection_all[k][:, 0]
        partBs = connection_all[k][:, 1]
        indexA, indexB = np.array(LIMB_SEQ[k]) - 1
        for i in range(connection_all[k].shape[0]):
            found = 0
            subset_idx = [-1, -1]
            for j in range(len(subset)):
                if subset[j][indexA] == partAs[i] or subset[j][indexB] == partBs[i]:
                    subset_idx[found] = j
                    found += 1
            if found == 1:
                j = subset_idx[0]
                if subset[j][indexB] != partBs[i]:
                    subset[j][indexB] = partBs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(partBs[i]), 2] + connection_all[k][i][2]
            elif found == 2:
                j1, j2 = subset_idx
                membership = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if np.count_nonzero(membership == 2) == 0:  # disjoint: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][indexB] = partBs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(partBs[i]), 2] + connection_all[k][i][2]
            elif not found and k < 17:
                row = -1 * np.ones(20)
                row[indexA] = partAs[i]
                row[indexB] = partBs[i]
                row[-1] = 2
                row[-2] = (candidate[connection_all[k][i, :2].astype(int), 2].sum()
                           + connection_all[k][i][2])
                subset = np.vstack([subset, row])
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


def draw_bodypose(h: int, w: int, candidate: np.ndarray, subset: np.ndarray) -> np.ndarray:
    """The skeleton on black, (h, w, 3) uint8: 17 limb ellipses (half width 4,
    blended 0.4 / 0.6) and 18 joint discs (radius 4), on the host."""
    canvas = torch.zeros(h, w, 3, dtype=torch.uint8)
    for k in range(17):
        for person in subset:
            ids = person[np.array(LIMB_SEQ[k]) - 1]
            if -1 in ids:
                continue
            ys = candidate[ids.astype(int), 1]
            xs = candidate[ids.astype(int), 0]
            m_x, m_y = xs.mean(), ys.mean()
            length = math.hypot(xs[0] - xs[1], ys[0] - ys[1])
            angle = math.degrees(math.atan2(ys[0] - ys[1], xs[0] - xs[1]))
            poly = ellipse2poly((int(m_x), int(m_y)), (int(length / 2), 4), int(angle), 0, 360, 1)
            cur = fill_convex_poly(canvas.clone(), poly, COLORS[k])
            canvas = add_weighted(canvas, 0.4, cur, 0.6, 0)
    for part in range(18):
        for person in subset:
            idx = int(person[part])
            if idx == -1:
                continue
            x, y = candidate[idx][0:2]
            circle(canvas, (int(x), int(y)), 4, COLORS[part])
    return canvas.numpy()


class OpenposeDetector:
    """controlnet_aux ``OpenposeDetector`` (body only) on a
    ``body_pose_model.pth``, the network fp32 on ``device``: uint8 RGB frames
    in, the drawn skeletons out, same size."""

    BOXSIZE, STRIDE, PAD_VALUE = 368, 8, 128

    def __init__(self, model_path: str, device: torch.device = torch.device("cpu")):
        self.device = torch.device(device)
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
        self.model = BodyPoseNet(device=self.device).eval().requires_grad_(False)
        self.model.load_state_dict(openpose_state_dict(sd), strict=True)

    @torch.no_grad()
    def maps(self, images: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n, h, w, 3) uint8 RGB frames of one shape -> (paf (n, h, w, 38),
        heat (n, h, w, 19)) on the device."""
        x = torch.from_numpy(np.ascontiguousarray(images[..., ::-1])).to(self.device)  # BGR
        n, h, w = x.shape[:3]
        scaled = torch.stack([resize_cubic(f, factor=0.5 * self.BOXSIZE / h) for f in x])
        sh, sw = scaled.shape[1:3]
        padded = F.pad(scaled.permute(0, 3, 1, 2), (0, (-sw) % self.STRIDE, 0,
                                                    (-sh) % self.STRIDE), value=self.PAD_VALUE)
        paf, heat = self.model(padded.to(torch.float32) / 256.0 - 0.5)
        both = torch.cat([paf, heat], dim=1)  # (n, 57, H/8, W/8): one resize of every map
        c = both.shape[1]
        both = both.permute(2, 3, 0, 1).reshape(*both.shape[2:], n * c)
        both = resize_cubic(both, factor=self.STRIDE)[:sh, :sw]
        both = resize_cubic(both.contiguous(), (h, w)).reshape(h, w, n, c).permute(2, 0, 1, 3)
        return both[..., :38], both[..., 38:]

    @staticmethod
    def _decode(paf: torch.Tensor, heat: torch.Tensor, ori_h: int, masks=None):
        all_peaks = find_peaks(heat, masks=masks)
        return assemble_subsets(all_peaks, score_connections(paf, all_peaks, ori_h))

    def detect_poses(self, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One (h, w, 3) uint8 RGB frame -> (candidate, subset)."""
        paf, heat = self.maps(np.asarray(rgb)[None])
        return self._decode(paf[0], heat[0], rgb.shape[0])

    def __call__(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        return as_batches(self.batch, images)

    def batch(self, images: np.ndarray) -> List[np.ndarray]:
        """(n, h, w, 3) uint8 frames of one shape -> their skeleton canvases."""
        paf, heat = self.maps(images)
        h, w = images.shape[1:3]
        masks = peak_masks(heat)
        return [draw_bodypose(h, w, *self._decode(paf[i], heat[i], h, masks[i]))
                for i in range(len(images))]
