"""Batched inference on one GPU or over a device mesh.

* `PoseInference`: counterpart of
  `openpose_tpu/parallel/inference.py::ShardedPoseInference`.  A batch of
  frames goes through per-scale resize -> CNN -> resize-and-merge -> NMS ->
  PAF scoring as one batch; outputs stay on the device, and `fetch` copies
  them to the host with the pair scores cut to the smallest
  `SCORE_BUCKETS` size that covers the batch's largest peak count.  The
  decode and the host assembly are `pose/extractor.py::BodyDecoder`'s,
  which `PoseExtractor` shares.
* `TopDownInference`: counterpart of `ShardedTopDown`: every frame of a
  batch crops up to `people_cap` square ROIs, one CNN forward covers all
  crops, a windowed argmax decodes them, and `extract` maps the keypoints
  back to frame pixels.  The original's crop-tier ladder is not ported: the
  port crops only the slots up to the last active one.

With a `mesh` (`parallel/mesh.py`), every rank calls with its own rows of
the global batch (`local_rows`) and gets its own outputs.  With a ``model``
dimension of 1 the call runs no collective: each rank's forward,
resize-merge, NMS and PAF scoring are its own.  With a larger one the
weights are held as the rank's shards and gathered at use, and the ranks of
one ``model`` group must pass the same rows.

On a card, `PoseInference` replays its CNN and its decode as CUDA graphs
(`parallel/graphs.py`) from the second call of a shape on, where the whole
net is on this rank (a ``model`` dimension of 1) and no capture is under
way; elsewhere, and on the first call of a shape, it runs eagerly.

Spans (`utils/profiler.py::TRACE`, off unless turned on): `pose.net`
(with `pose.net.trunk` and `pose.net.stages` once a scale: the CNN's two
parts, `models/graph.py::PoseNet`), `pose.decode` (with
`pose.decode.merge`, `.nms`, `.paf`), `pose.fetch.wait` (`fetch_end`: the
host blocked on the device), `pose.assemble`, `topdown.fetch`; counters
`pose.graph.captures`, `.replays` and `.eager` (once per call of
`net_outputs` or `decode`), `topdown.crops_computed` (slots sent through
the net) and `topdown.crops_active` (slots with a rect to crop).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from openpose_tpu_torch.models import graph
from openpose_tpu_torch.models.zoo import Model
from openpose_tpu_torch.ops import maximum, resize, warp
from openpose_tpu_torch.parallel import mesh as mesh_lib
from openpose_tpu_torch.parallel.graphs import GraphCache
from openpose_tpu_torch.params import (
    POSE_MAX_PEOPLE, PoseModel, default_connect_params)
from openpose_tpu_torch.pose import scaler
from openpose_tpu_torch.pose.extractor import BodyDecoder, net_to_output_scale
from openpose_tpu_torch.utils.profiler import TRACE


Rect = Tuple[float, float, float, float]


def rect_is_active(rect: Rect) -> bool:
    """Big enough to crop (handExtractorCaffe.cpp:363)."""
    return min(rect[2], rect[3]) > 1 and rect[2] * rect[3] > 10


def _mesh_setup(owner, model: Model, mesh, device) -> None:
    """The device, mesh and net of an inference object: the model's own net
    on `device`, or with a mesh the rank's device and, where the mesh has a
    ``model`` dimension above 1, a net over the rank's weight shards."""
    owner.mesh = mesh
    owner.device = mesh_lib.rank_device(mesh, device)
    model.net.to(owner.device)
    owner.net = model.net
    if mesh_lib.size(mesh, "model") > 1:
        owner.net = graph.PoseNet(model.spec, mesh_lib.shard_params(
            mesh, model.net.params()))


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """Start a copy of t to host memory; on a CUDA tensor it is
    asynchronous (pinned memory) and done once the stream passes it."""
    if not t.is_cuda:
        return t.contiguous()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class PoseInference:
    """Batched BODY-model inference on one device, or on this rank's rows
    over a mesh."""

    # the [B, P, K, K] scores dominate the device->host volume (1.7 MB per
    # frame at K = 127) while assembly reads only the [:count, :count] corner
    SCORE_BUCKETS = (8, 16, 32, 64)

    def __init__(self, model: Model, net_hw: Tuple[int, int] = (368, 656),
                 device: Union[str, torch.device, None] = None,
                 max_peaks: int = POSE_MAX_PEOPLE,
                 nms_threshold: float = 0.05, inter_threshold: float = 0.05,
                 inter_min_above_threshold: float = 0.95,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 scale_number: int = 1, scale_gap: float = 0.25,
                 frame_hw: Optional[Tuple[int, int]] = None,
                 net_bypass: bool = False, mesh=None,
                 maximize_positives: bool = False):
        """frame_hw: if given, `__call__` takes raw frames [B, fh, fw, 3] and
        every scale resamples the frame on the device (the reference's
        multi-scale semantics); if None, frames are pre-sized scale-0 net
        inputs [B, net_h, net_w, 3] and the smaller scales are derived from
        that canvas.

        net_bypass: `__call__` takes net outputs [B, net_h/8, net_w/8, C]
        and skips the CNN (the reference's Datum::poseNetOutput hook);
        single scale, pre-sized only.

        mesh: a `parallel.mesh.make_mesh` mesh; every rank then calls with
        its own rows of the global batch (`local_rows`).  The device is the
        rank's (`mesh.rank_device`).

        maximize_positives: assemble with the flag's limits and passes
        (`default_connect_params(model, maximize_positives)`), the three
        thresholds above in place of its own, as `PoseExtractor` does."""
        if net_bypass and (scale_number != 1 or frame_hw is not None):
            raise ValueError("net_bypass supports only single-scale, "
                             "pre-sized inputs (like the reference hook)")
        _mesh_setup(self, model, mesh, device)
        self.model = model
        self.net_hw = net_hw
        self.compute_dtype = compute_dtype
        self.frame_hw = frame_hw
        self.net_bypass = net_bypass
        connect = dataclasses.replace(
            default_connect_params(PoseModel(model.info.name),
                                   maximize_positives),
            nms_threshold=nms_threshold, inter_threshold=inter_threshold,
            inter_min_above_threshold=inter_min_above_threshold)
        self.decoder = BodyDecoder(model.info, max_peaks, connect,
                                   maximize_positives, self.device)

        net_h, net_w = net_hw
        in_wh = (net_w, net_h) if frame_hw is None \
            else (frame_hw[1], frame_hw[0])
        self.plan = scaler.extract_scales(in_wh, (net_w, net_h),
                                          scale_number, scale_gap)
        self.scale_net_to_output = net_to_output_scale(self.plan, in_wh)
        self._graphs = GraphCache(self.device)

    @property
    def data_parallelism(self) -> int:
        """The number of data shards a global batch is cut into."""
        return mesh_lib.size(self.mesh, "data")

    def local_rows(self, batch: int) -> slice:
        """This rank's rows of a global batch (`mesh.local_rows`)."""
        return mesh_lib.local_rows(self.mesh, batch)

    def _check_input(self, x: torch.Tensor) -> None:
        if self.net_bypass:
            net_h, net_w = self.net_hw
            want = (net_h // 8, net_w // 8, self.model.info.heatmap_channels)
        else:
            want = (*(self.frame_hw or self.net_hw), 3)
        if x.ndim != 4 or tuple(x.shape[1:]) != want:
            raise ValueError(f"inputs must be [B, {', '.join(map(str, want))}]"
                             f", got {tuple(x.shape)}")

    def _graphable(self, tensors: Sequence[torch.Tensor] = ()) -> bool:
        """Whether a call on `tensors` may replay CUDA graphs: on a card
        (the current device or not), the tensors on it, with the whole net
        on this rank (a model-sharded net gathers its weights with
        collectives at use), and outside another capture on that card."""
        if (self.device.type != "cuda"
                or not all(t.is_cuda for t in tensors)
                or mesh_lib.size(self.mesh, "model") != 1):
            return False
        with torch.cuda.device(self.device):
            return not torch.cuda.is_current_stream_capturing()

    @torch.inference_mode()
    def net_outputs(self, images: Union[np.ndarray, torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Per-scale net outputs [B, h_s, w_s, C] float32 (the inputs
        themselves with net_bypass)."""
        with TRACE.span("pose.net"):
            x = torch.as_tensor(images)
            self._check_input(x)
            if self.net_bypass:
                # an upload and a cast: nothing to replay
                return [x.to(self.device, non_blocking=True)
                        .to(torch.float32)]
            return self._graphs.run(self._net, [x], self._graphable())

    def _net(self, inputs, stage) -> List[torch.Tensor]:
        # each scale's trunk and CPM stages run in `stage`s of their own
        # (the net's `TRUNK` and `STAGES`).  A scale's input is made first
        # thing in its trunk's stage (the upload and cast in the first
        # scale's): a stage of its own would be one more graph launch
        x = None
        net_h, net_w = self.net_hw
        scales = self.plan.scale_input_to_net

        def net_input(w_i, h_i, s_i):
            nonlocal x
            if x is None:
                # uint8 frames go to the device as they are and become
                # float there
                x = inputs[0].to(self.device, non_blocking=True) \
                    .to(torch.float32)
            if self.frame_hw is not None:
                # each scale resamples the frame
                net_in = resize.resize_fixed_aspect(x, s_i, (h_i, w_i))
            elif (w_i, h_i) == (net_w, net_h):
                net_in = x
            else:
                # derived from the scale-0 canvas (s_0 == 1 here)
                net_in = resize.resize_fixed_aspect(x, s_i / scales[0],
                                                    (h_i, w_i))
            return resize.normalize_vgg(net_in)

        return [self.net(functools.partial(net_input, w_i, h_i, s_i),
                         self.compute_dtype, stage)
                for (w_i, h_i), s_i in zip(self.plan.net_input_sizes,
                                           scales)]

    @torch.inference_mode()
    def decode(self, sources: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-scale net outputs -> (peaks [B, parts, K+1, 3], pair scores
        [B, P, K, K]) on the device; `paf.paf_scores_multiscale` picks the
        PAF backend by the peak budget."""
        sources = list(sources)
        with TRACE.span("pose.decode"):
            return self._graphs.run(self._decode, sources,
                                    self._graphable(sources))

    def _decode(self, sources, stage) -> Tuple[torch.Tensor, torch.Tensor]:
        # the +0.5 refinement offset in input pixels after the host
        # rescale (poseExtractorCaffe.cpp:317-318)
        return self.decoder.decode(
            sources, self.plan.scale_input_to_net, self.net_hw,
            float(0.5 / self.scale_net_to_output), stage)

    def __call__(self, images: Union[np.ndarray, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, net_h, net_w, 3] BGR uint8 or float 0..255; raw
        [B, fh, fw, 3] frames with frame_hw; net outputs with net_bypass.
        Over a mesh, B is this rank's rows.  Returns (peaks [B, parts, K+1,
        3], pair scores [B, P, K, K]), both on the device."""
        return self.decode(self.net_outputs(images))

    def fetch(self, peaks: torch.Tensor, scores: torch.Tensor
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Device outputs -> host arrays, the score matrix sliced on the
        device to the smallest bucket covering the batch's max peak count."""
        return self.fetch_end(self.fetch_begin(peaks, scores))

    def fetch_begin(self, peaks: torch.Tensor, scores: torch.Tensor):
        """Start the device->host copies of the peaks and of the smallest
        bucket's score slice without waiting; when the batch's largest peak
        count fits that bucket, `fetch_end` needs no further copy."""
        k0 = self.SCORE_BUCKETS[0]
        copies = (_host_copy(peaks), _host_copy(scores[:, :, :k0, :k0]))
        done = None
        if peaks.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(peaks.device))
        return scores, copies, k0, done

    def fetch_end(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        scores, (peaks_host, head_host), k0, done = handle
        with TRACE.span("pose.fetch.wait"):
            if done is not None:
                done.synchronize()
            peaks = peaks_host.numpy()
            max_count = int(peaks[:, :, 0, 0].max()) if peaks.size else 0
            if max_count <= k0:
                return peaks, head_host.numpy()
            for k in self.SCORE_BUCKETS:
                if max_count <= k < self.decoder.max_peaks:
                    return peaks, scores[:, :, :k, :k].cpu().numpy()
            return peaks, scores.cpu().numpy()

    def assemble(self, peaks: np.ndarray, scores: np.ndarray,
                 scale_net_to_output: Optional[float] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Host tail for one fetched frame: peaks [parts, K+1, 3] and scores
        [P, k, k] -> (keypoints [people, parts, 3] in input pixels, person
        scores [people]).  scale_net_to_output: the frame's own net-to-source
        scale where the frames were resized to the net input before they
        came here (`runtime/video_runner.py`); the plan's when None."""
        if scale_net_to_output is None:
            scale_net_to_output = self.scale_net_to_output
        with TRACE.span("pose.assemble"):
            return self.decoder.assemble(peaks, scores, scale_net_to_output)


class TopDownInference:
    """Batched per-person crop extraction for a whole frame batch.

    Every frame crops up to `people_cap` square ROIs from itself, one CNN
    forward covers all crops, and `maximum.channel_argmax_refined` decodes
    them (the windowed equivalent of the reference's 8x upsample + argmax).
    Only the leading slots up to the last active one are cropped; the
    slots after it are zero, as in the JAX package's crop-tier programs.
    """

    # transform row for an inactive slot: every sample far outside -> zeros
    INACTIVE = (1.0, 1.0, -1e6, -1e6)

    def __init__(self, model: Model, net_size: int = 368,
                 people_cap: int = 8,
                 device: Union[str, torch.device, None] = None,
                 compute_dtype: torch.dtype = torch.bfloat16, mesh=None):
        """mesh: as `PoseInference`'s; every rank calls with its own rows."""
        _mesh_setup(self, model, mesh, device)
        self.model = model
        self.net_size = net_size
        self.people_cap = people_cap
        self.compute_dtype = compute_dtype
        self.channels = graph.channels(model.spec)[model.spec.output]

    @staticmethod
    def active_slots(transforms: np.ndarray) -> int:
        """1 + the highest active slot of any frame (0 when none is)."""
        active = np.asarray(transforms)[..., 2] > -1e5   # INACTIVE tx = -1e6
        return int(np.nonzero(active)[-1].max()) + 1 if active.any() else 0

    @torch.inference_mode()
    def __call__(self, frames: Union[np.ndarray, torch.Tensor],
                 transforms: np.ndarray,
                 net_output: Optional[Union[np.ndarray, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """frames [B, H, W, 3]; transforms [B, people_cap, 4] host rows
        (`warp.rect_to_transform`, `INACTIVE` for an empty slot).  Returns
        [B, people_cap, C, 3] peaks in crop coordinates on the device (map
        them back with `warp.map_back`).

        net_output: optional [B, people_cap, s/8, s/8, C] net outputs that
        replace the crop and CNN stages (decode only)."""
        if net_output is not None:
            maps = torch.as_tensor(net_output).to(self.device, torch.float32)
            b, p = maps.shape[:2]
            peaks = maximum.channel_argmax_refined(
                maps.reshape(b * p, *maps.shape[2:]))
            return peaks.reshape(b, p, *peaks.shape[1:])
        transforms = np.asarray(transforms, np.float32)
        x = torch.as_tensor(frames).to(self.device, non_blocking=True)
        b, k, s = x.shape[0], self.active_slots(transforms), self.net_size
        out = torch.zeros((b, self.people_cap, self.channels, 3),
                          dtype=torch.float32, device=self.device)
        if k == 0:
            return out
        if TRACE.enabled:
            TRACE.count("topdown.crops_computed", b * k)
            TRACE.count("topdown.crops_active",
                        int((transforms[:, :k, 2] > -1e5).sum()))
        tr = torch.from_numpy(np.ascontiguousarray(transforms[:, :k]))
        if self.device.type == "cuda":
            # through pinned memory: a copy from pageable memory would
            # wait for the card
            tr = tr.pin_memory()
        crops = warp.crop_affine_batch(
            x.to(torch.float32), tr.to(self.device, non_blocking=True), s)
        maps = self.net(resize.normalize_vgg(crops.reshape(b * k, s, s, 3)),
                        self.compute_dtype)
        out[:, :k] = maximum.channel_argmax_refined(maps).reshape(
            b, k, self.channels, 3)
        return out

    def extract(self, frames: Union[np.ndarray, torch.Tensor],
                crops: Sequence[Sequence[Tuple[Rect, bool]]],
                num_parts: int) -> List[np.ndarray]:
        """frames [B, H, W, 3]; crops[i] the (rect, mirror) pairs of frame
        i.  Returns per frame [len(crops[i]), num_parts, 3] keypoints in
        frame pixels; a rect too small to crop, or past `people_cap`,
        yields zeros."""
        b, cap = len(crops), self.people_cap
        transforms = np.tile(np.asarray(self.INACTIVE, np.float32),
                             (b, cap, 1))
        active: List[List[Tuple[int, tuple]]] = []
        for i, frame_crops in enumerate(crops):
            rows = []
            for slot, (rect, mirror) in enumerate(frame_crops[:cap]):
                if rect_is_active(rect):
                    tr = warp.rect_to_transform(rect, self.net_size, mirror)
                    transforms[i, slot] = tr
                    rows.append((slot, tr))
            active.append(rows)
        if any(active):
            peaks_dev = self(frames, transforms)
            with TRACE.span("topdown.fetch"):
                peaks = peaks_dev.cpu().numpy()
        per_frame = []
        for i, frame_crops in enumerate(crops):
            kp = np.zeros((len(frame_crops), num_parts, 3), np.float32)
            for slot, tr in active[i]:
                raw = peaks[i, slot, :num_parts]     # drop the background
                kp[slot, :, :2] = warp.map_back(raw[:, :2], tr)
                kp[slot, :, 2] = raw[:, 2]
            per_frame.append(kp)
        return per_frame
