"""Everything a run feeds the program and the reference, made from --seed.

* weights: He-normal convolutions, small biases and PReLU slopes from a
  `torch.Generator` on the run's device, three large draws per net;
* frames: uint8 BGR noise drawn on the device, kept in pinned host memory
  (the runner uploads from there every step);
* people: a frozen copy of the port's `synthetic.random_people` (standing
  figures spread across the frame), drawn per frame;
* rendered net outputs: a frozen copy of the port's `synthetic.make_targets`
  (Gaussian part maps, background, unit-vector limb bands), i.e. what a
  trained net of the configuration outputs for those people, kept on the
  device.  People are drawn as BODY_25 and projected onto the
  configuration's own parts (its `keypoints_from_body25`: one BODY_25 index
  a part, in the configuration's order; all 25 in order without it).
  Random weights find no real people, so the decode and the stages after
  it are fed these, through the program's injection path.

Every draw takes its own stream, named by what it makes, from one
`numpy.random.SeedSequence` of the seed, so the same seed gives the same
inputs whatever else a run makes, and the draws of one batch do not depend
on the rank that makes it.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import cnn


def stream(seed: int, *tags) -> int:
    """A 63-bit seed for the draw named by `tags`."""
    text = ":".join(map(str, (seed,) + tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def make_params(spec_name: str, seed: int, device: torch.device
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{layer: {"w": OIHW, "b"} or {"slope"}} float32 on `device`."""
    convs, prelus = cnn.learned_layers(cnn.load_spec(spec_name))
    gen = torch.Generator(device=device)
    gen.manual_seed(stream(seed, "weights", spec_name))
    n_w = sum(o * i * k * k for _, i, o, k in convs)
    flat_w = torch.randn(n_w, generator=gen, device=device)
    flat_b = torch.randn(sum(o for _, _, o, _ in convs), generator=gen,
                         device=device) * 0.01
    flat_s = torch.rand(sum(c for _, c in prelus), generator=gen,
                        device=device) * 0.2 + 0.15
    params, ow, ob = {}, 0, 0
    for name, c_in, c_out, k in convs:
        n = c_out * c_in * k * k
        w = flat_w[ow:ow + n].view(c_out, c_in, k, k)
        w.mul_(math.sqrt(2.0 / (c_in * k * k)))
        params[name] = {"w": w, "b": flat_b[ob:ob + c_out]}
        ow, ob = ow + n, ob + c_out
    os_ = 0
    for name, c in prelus:
        params[name] = {"slope": flat_s[os_:os_ + c]}
        os_ += c
    return params


def make_frames(seed: int, batch_index: int, rows: slice, batch: int,
                hw: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """Rows `rows` of pool batch `batch_index` ([batch, H, W, 3] uint8
    noise), in pinned host memory when `device` is a card."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream(seed, "frames", batch_index))
    full = torch.randint(0, 256, (batch, hw[0], hw[1], 3), generator=gen,
                         device=device, dtype=torch.uint8)
    host = full[rows].cpu()
    return host.pin_memory() if device.type == "cuda" else host


# --- frozen copy of the port's synthetic.random_people ---------------------

BODY25_TEMPLATE = np.array([
    (0.000, 0.000), (0.000, 0.120), (-0.100, 0.120), (-0.140, 0.260),
    (-0.160, 0.400), (0.100, 0.120), (0.140, 0.260), (0.160, 0.400),
    (0.000, 0.450), (-0.060, 0.450), (-0.070, 0.650), (-0.080, 0.850),
    (0.060, 0.450), (0.070, 0.650), (0.080, 0.850), (-0.025, -0.030),
    (0.025, -0.030), (-0.055, -0.010), (0.055, -0.010), (0.100, 0.920),
    (0.120, 0.910), (0.070, 0.880), (-0.100, 0.920), (-0.120, 0.910),
    (-0.070, 0.880)], np.float32)


def random_people(rng: np.random.Generator, n_people: int,
                  frame_hw: Tuple[int, int],
                  height_range: Tuple[float, float] = (180.0, 300.0),
                  jitter: float = 2.0, min_spacing: float = 90.0
                  ) -> np.ndarray:
    """[n_people, 25, 3] keypoints of standing people spread across a
    frame, all visible, centres at least `min_spacing` px apart."""
    h, w = frame_hw
    people = np.zeros((n_people, 25, 3), np.float32)
    margin = 60.0
    slots = np.linspace(margin, w - margin,
                        max(n_people, int((w - 2 * margin) // min_spacing)))
    rng.shuffle(slots)
    for p in range(n_people):
        height = min(rng.uniform(*height_range), (h - 20.0) / 0.95)
        cx = slots[p % len(slots)] + rng.uniform(-15, 15)
        top = rng.uniform(8.0, max(9.0, h - height * 0.95 - 8.0))
        pts = BODY25_TEMPLATE.copy()
        if rng.random() < 0.5:
            pts[:, 0] = -pts[:, 0]
        kp = pts * height
        kp[:, 0] += cx
        kp[:, 1] += top + height * 0.03
        kp += rng.uniform(-jitter, jitter, kp.shape)
        kp[:, 0] = np.clip(kp[:, 0], 2.0, w - 3.0)
        kp[:, 1] = np.clip(kp[:, 1], 2.0, h - 3.0)
        people[p, :, :2] = kp
        people[p, :, 2] = 1.0
    return people


def batch_people(seed: int, batch_index: int, batch: int,
                 people_range: Tuple[int, int], hw: Tuple[int, int]
                 ) -> np.ndarray:
    """[batch, max people, 25, 3] of pool batch `batch_index` (empty slots
    zero).  The counts are fixed by the batch's place in the pool --
    frame j of the pool holds lo + j mod (hi - lo + 1) people -- and only
    their order within the batch and the people themselves come from the
    seed, so every seed gives the pool the same work."""
    lo, hi = people_range
    rng = np.random.default_rng(stream(seed, "people", batch_index))
    first = batch_index * batch
    counts = rng.permutation(lo + (np.arange(first, first + batch)
                                   % (hi - lo + 1)))
    out = np.zeros((batch, int(counts.max()), 25, 3), np.float32)
    for i, n in enumerate(counts):
        out[i, :n] = random_people(rng, int(n), hw)
    return out


# --- frozen copy of the port's synthetic.make_targets ----------------------

def make_targets(keypoints: np.ndarray, pairs: np.ndarray,
                 map_idx: np.ndarray, hw: Tuple[int, int], num_parts: int,
                 num_channels: int, stride: int = 8, sigma: float = 7.0,
                 paf_width: float = 1.0) -> np.ndarray:
    """keypoints [B, people, parts, 3] in input pixels (score > 0 = valid)
    -> [B, H/stride, W/stride, C] float32: parts, background, PAFs;
    map_idx holds absolute channel indices."""
    kp = np.asarray(keypoints, np.float32)
    h, w = hw[0] // stride, hw[1] // stride
    grid_y = ((np.arange(h, dtype=np.float32) + 0.5) * stride - 0.5)[:, None]
    grid_x = ((np.arange(w, dtype=np.float32) + 0.5) * stride - 0.5)[None, :]
    kx, ky, kv = kp[..., 0], kp[..., 1], kp[..., 2] > 0
    d2 = ((grid_x - kx[..., None, None]) ** 2
          + (grid_y - ky[..., None, None]) ** 2)
    g = np.where(kv[..., None, None], np.exp(-d2 / (2.0 * sigma * sigma)), 0.0)
    conf = g.max(axis=1).transpose(0, 2, 3, 1)
    bkg = np.clip(1.0 - conf.max(axis=-1, keepdims=True), 0.0, 1.0)
    pa, pb = pairs[:, 0], pairs[:, 1]
    ax, ay, bx, by = kx[:, :, pa], ky[:, :, pa], kx[:, :, pb], ky[:, :, pb]
    pv = kv[:, :, pa] & kv[:, :, pb]
    vx, vy = bx - ax, by - ay
    norm = np.sqrt(vx * vx + vy * vy)
    nz = norm > 1e-3
    ux = np.where(nz, vx / np.maximum(norm, 1e-3), 0.0)[..., None, None]
    uy = np.where(nz, vy / np.maximum(norm, 1e-3), 0.0)[..., None, None]
    px = grid_x - ax[..., None, None]
    py = grid_y - ay[..., None, None]
    along = px * ux + py * uy
    perp = np.abs(px * uy - py * ux)
    margin = paf_width * stride
    on_limb = ((along >= -margin) & (along <= norm[..., None, None] + margin)
               & (perp <= paf_width * stride) & (pv & nz)[..., None, None])
    denom = np.maximum(on_limb.sum(axis=1), 1).astype(np.float32)
    paf_x = np.where(on_limb, ux, 0.0).sum(axis=1) / denom
    paf_y = np.where(on_limb, uy, 0.0).sum(axis=1) / denom
    off = num_parts + 1
    paf = np.zeros((kp.shape[0], num_channels - off, h, w), np.float32)
    paf[:, map_idx[:, 0] - off] = paf_x
    paf[:, map_idx[:, 1] - off] = paf_y
    return np.concatenate([conf, bkg, paf.transpose(0, 2, 3, 1)],
                          axis=-1).astype(np.float32)


def rendered(cfg: dict, people: np.ndarray) -> np.ndarray:
    """The net outputs a trained body net of `cfg` gives for `people`
    [B, P, 25, 3] (BODY_25 parts).  Raises ValueError where the
    configuration's parts, pairs and PAF channels do not fit its net, so
    that traffic for another net stops the run at set-up."""
    parts = cfg["num_parts"]
    pairs = np.asarray(cfg["pairs"], np.int64).reshape(-1, 2)
    map_idx = np.asarray(cfg["map_idx"], np.int64).reshape(-1, 2)
    channels = cnn.output_channels(cnn.load_spec(cfg["spec"]))
    drawn = len(BODY25_TEMPLATE)
    picked = np.asarray(cfg.get("keypoints_from_body25", range(drawn)),
                        np.int64)
    faults = []
    if picked.size != parts:
        faults.append(f"{picked.size} parts drawn for num_parts {parts} "
                      "(keypoints_from_body25 maps BODY_25's parts onto "
                      "the configuration's)")
    if ((picked < 0) | (picked >= drawn)).any():
        faults.append("keypoints_from_body25 names a part outside BODY_25's"
                      f" 0-{drawn - 1}")
    if parts + 1 + 2 * len(pairs) != channels:
        faults.append(f"num_parts + 1 + 2 x {len(pairs)} pairs is not the "
                      f"{channels} output channels of spec {cfg['spec']!r}")
    if ((pairs < 0) | (pairs >= parts)).any():
        faults.append(f"a pair names a part outside 0-{parts - 1}")
    if ((map_idx < 0) | (map_idx >= 2 * len(pairs))).any():
        faults.append("map_idx names a PAF channel outside "
                      f"0-{2 * len(pairs) - 1}")
    if faults:
        raise ValueError(f"configuration {cfg['name']!r}: "
                         + "; ".join(faults))
    return make_targets(people[:, :, picked], pairs, map_idx + parts + 1,
                        tuple(cfg["net_hw"]), parts, channels)


class Pool:
    """The pool of batches a cell cycles through: per batch, this rank's
    frames (host), rendered net outputs (device) and people."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, rows: slice,
                 device: torch.device):
        hw = tuple(cfg["net_hw"])
        batch = traffic["batch"]
        self.frames: List[torch.Tensor] = []
        self.maps: List[torch.Tensor] = []
        self.people: List[np.ndarray] = []
        for b in range(traffic["pool"]):
            people = batch_people(seed, b, batch, tuple(traffic["people"]),
                                  hw)[rows]
            self.people.append(people)
            self.frames.append(make_frames(seed, b, rows, batch, hw, device))
            self.maps.append(torch.from_numpy(rendered(cfg, people))
                             .to(device))

    def __len__(self) -> int:
        return len(self.frames)
