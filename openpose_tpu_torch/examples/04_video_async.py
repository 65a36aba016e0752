"""Tutorial 04: asynchronous video processing with the host pipeline.

    python -m openpose_tpu_torch.examples.04_video_async video.avi [--cpu]
"""

from __future__ import annotations

from openpose_tpu_torch.runtime.pipeline import AsyncPipeline
from openpose_tpu_torch.wrapper import PoseConfig, Wrapper


def video_async(frames, pose=None, device=None):
    """Every frame through `Wrapper.process` in an `AsyncPipeline` (reader,
    device loop and consumer overlapped, two frames in flight).  frames:
    an iterable of view lists, as a producer's `frames()` gives them.
    Returns (the pipeline's stats, each frame's pose keypoints in order)."""
    wrapper = Wrapper(pose=pose or PoseConfig(), device=device)
    results = []
    pipe = AsyncPipeline(
        frames,
        process=lambda views: wrapper.process(views[0].image,
                                              views[0].frame_id),
        consumer=lambda d: results.append(d.pose_keypoints),
        in_flight=2)
    stats = pipe.run()
    print(f"{stats.frames} frames at {stats.fps:.2f} fps")
    return stats, results


if __name__ == "__main__":
    import argparse

    from openpose_tpu_torch.io.producers import VideoReader
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("video", nargs="?", default="video.avi")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    video_async(VideoReader(args.video).frames(),
                device="cpu" if args.cpu else None)
