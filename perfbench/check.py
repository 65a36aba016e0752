"""The comparison that decides `correct`.

After the window, with the program's state freed, the reference works out
again, from the same raw inputs, what the timed path produced:

* `cnn_rel_err`: the CNN outputs of the sampled steps against the float32
  reference CNN on the same frames, ||program - reference|| / ||reference||
  per frame, the worst frame;
* `keypoint_gap`: every frame the window answered against the reference
  decode of its rendered net outputs: people matched one to one, the
  largest gap of a keypoint's x, y or score or of a person's score (a
  different number of people reads `MISMATCH`);
* `topdown_gap` (whole body): every face and hand crop of every answered
  frame against the reference's float32 face and hand nets on its own
  crops: for each channel, the larger of the gap of the program's peak
  score to the reference's and of the reference's best value above its
  value at the program's peak (the served-token rule), over the crop's
  largest reference score; an active crop where the reference has none,
  or the reverse, reads `MISMATCH`;
* `missing_answers`: frames of the answered batches with no answer.

The control (`control.py`) is the reference at the precision below the
configuration's, put in the program's place: its answers and CNN outputs
are judged by the same functions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import cnn, decode, topdown

MISMATCH = 1e3


def people_gap(prog_kp: np.ndarray, prog_scores: np.ndarray,
               ref_kp: np.ndarray, ref_scores: np.ndarray) -> float:
    """Largest |difference| over matched people (greedy on the keypoint
    gap), MISMATCH where the counts differ."""
    prog_kp = np.asarray(prog_kp, np.float64).reshape(-1, *ref_kp.shape[1:])
    if prog_kp.shape != ref_kp.shape:
        return MISMATCH
    worst, free = 0.0, list(range(len(prog_kp)))
    for r in range(len(ref_kp)):
        gaps = [max(float(np.abs(prog_kp[p] - ref_kp[r]).max()),
                    abs(float(prog_scores[p]) - float(ref_scores[r])))
                for p in free]
        j = int(np.argmin(gaps))
        worst = max(worst, gaps[j])
        free.pop(j)
    return worst


def cnn_rel_err(spec_name: str, params, samples: Sequence, frames_of,
                precision: str = "float32") -> Optional[float]:
    """Worst per-frame relative L2 error of sampled CNN outputs (the
    reference's forward once for each pool batch the sample holds)."""
    spec = cnn.load_spec(spec_name)
    worst = None
    for b in sorted({b for b, _ in samples}):
        outs = [out for sb, out in samples if sb == b]
        ref = cnn.forward(spec, params, frames_of(b).to(outs[0].device))
        for out in outs:
            for i in range(out.shape[0]):
                err = float(torch.linalg.vector_norm(out[i].float() - ref[i])
                            / torch.linalg.vector_norm(ref[i])
                            .clamp(min=1e-30))
                worst = err if worst is None else max(worst, err)
        del ref
    return worst


def _crop_gap(prog: Optional[np.ndarray], ref, num_parts: int) -> float:
    """One crop: prog [num_parts, 3] frame px (zeros when the program had
    no crop); ref (transform, maps, peaks) or Nones."""
    tr, maps, peaks = ref
    prog = np.zeros((num_parts, 3), np.float32) if prog is None else prog
    if tr is None:
        return 0.0 if not np.any(prog) else MISMATCH
    if not np.any(prog):
        return MISMATCH
    sx, sy, tx, ty = tr
    xy = np.stack([(prog[:, 0] - tx) / sx, (prog[:, 1] - ty) / sy], -1)
    xy_t = torch.from_numpy(xy.astype(np.float32)).to(maps.device)
    at_prog = topdown.upsampled_value(maps[None, ..., :num_parts],
                                      xy_t[None])[0].cpu().numpy()
    ref_score = peaks[:num_parts, 2].cpu().numpy()
    scale = max(float(np.abs(ref_score).max()), 1e-12)
    gap = np.maximum(np.abs(prog[:, 2] - ref_score),
                     np.maximum(ref_score - at_prog, 0.0))
    return float(gap.max() / scale)


class Reference:
    """The reference's answers for the pool batches, worked out once a
    batch and judged against every answer the window gave for it."""

    def __init__(self, cfg: dict, pool, params: Dict[str, dict],
                 device: torch.device, control: bool = False,
                 tf32: Optional[bool] = None):
        """control: the nets in fp8 and the heatmap path in TF32 (tf32, if
        given, sets the latter alone)."""
        self.cfg, self.pool, self.params = cfg, pool, params
        self.device = device
        self.tf32 = control if tf32 is None else tf32
        self.stages = None
        if "face" in cfg:
            self.precision = "fp8" if control else "float32"
            self.stages = (
                topdown.Stage(cfg["face"]["spec"], params["face"],
                              cfg["face"]["net_size"], topdown.face_crops,
                              cfg["face"]["num_parts"]),
                topdown.Stage(cfg["hand"]["spec"], params["hand"],
                              cfg["hand"]["net_size"], topdown.hand_crops,
                              cfg["hand"]["num_parts"]))

    def body(self, b: int):
        return decode.decode(self.pool.maps[b], self.cfg, tf32=self.tf32)

    def whole(self, b: int):
        """Per frame: (kept keypoints, scores, face crops, hand crops)."""
        cap = self.cfg["people_cap"]
        kept = [topdown.keep_top_n(kp, s, cap) for kp, s in self.body(b)]
        frames = self.pool.frames[b].to(self.device)
        face, hand = self.stages
        faces = face.run(frames, [k for k, _ in kept], cap, self.precision)
        hands = hand.run(frames, [k for k, _ in kept], 2 * cap,
                         self.precision)
        return [(k, s, f, h) for (k, s), f, h in zip(kept, faces, hands)]

    def as_answers(self, b: int) -> list:
        """This reference's own answers in the program's format (the
        control's answers)."""
        if self.stages is None:
            return self.body(b)
        out = []
        for kp, s, faces, hands in self.whole(b):
            def frame_px(crops, n):
                arr = np.zeros((len(crops), n, 3), np.float32)
                for j, (tr, _, peaks) in enumerate(crops):
                    if tr is not None:
                        p = peaks[:n].cpu().numpy()
                        arr[j, :, 0] = tr[0] * p[:, 0] + tr[2]
                        arr[j, :, 1] = tr[1] * p[:, 1] + tr[3]
                        arr[j, :, 2] = p[:, 2]
                return arr
            f = frame_px(faces, self.cfg["face"]["num_parts"])
            h = frame_px(hands, self.cfg["hand"]["num_parts"])
            out.append((kp, s, f[:len(kp)], h[0::2][:len(kp)],
                        h[1::2][:len(kp)]))
        return out


def _content(frames: list) -> bytes:
    """The bytes of a batch's answers (arrays and None alike)."""
    parts = []
    for answer in frames:
        for arr in answer:
            parts.append(b"-" if arr is None else
                         np.ascontiguousarray(arr).tobytes()
                         + str(np.shape(arr)).encode())
    return b"|".join(parts)


def judge(ref: Reference, answers: List[tuple], rows: int
          ) -> Dict[str, float]:
    """Every answer of the window against the reference of its batch."""
    kp_gap, td_gap, missing = 0.0, 0.0, 0
    by_batch: Dict[int, List[list]] = {}
    for b, frames in answers:
        by_batch.setdefault(b, []).append(frames)
    for b, runs in by_batch.items():
        if ref.stages is None:
            want = ref.body(b)
        else:
            want = ref.whole(b)
        seen = set()
        for frames in runs:
            missing += max(0, rows - len(frames))
            # an answer equal to one judged already, bit for bit, reads
            # the same gaps
            key = _content(frames)
            if key in seen:
                continue
            seen.add(key)
            for got, exp in zip(frames, want):
                kp_gap = max(kp_gap, people_gap(got[0], got[1], exp[0],
                                                exp[1]))
                if ref.stages is None:
                    continue
                n_people = len(exp[0])
                if got[2] is None or len(got[2]) != n_people:
                    td_gap = MISMATCH
                    continue
                nf = ref.cfg["face"]["num_parts"]
                nh = ref.cfg["hand"]["num_parts"]
                face_crops, hand_crops = exp[2], exp[3]
                for p in range(n_people):
                    td_gap = max(td_gap, _crop_gap(got[2][p], face_crops[p],
                                                   nf))
                    td_gap = max(td_gap, _crop_gap(got[3][p],
                                                   hand_crops[2 * p], nh))
                    td_gap = max(td_gap, _crop_gap(got[4][p],
                                                   hand_crops[2 * p + 1], nh))
    out = {"keypoint_gap": kp_gap, "missing_answers": float(missing)}
    if ref.stages is not None:
        out["topdown_gap"] = td_gap
    return out
