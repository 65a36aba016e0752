"""Tutorial 05: multi-camera 3-D triangulation (reference --3d pipeline).

    python -m openpose_tpu_torch.examples.05_multiview_3d image_dir/ \\
        camera_dir/ [--cpu]

Frames are horizontally stacked views, the camera XMLs in camera_dir;
writes the first frame's 3-D skeletons to skeleton3d.png.
"""

from __future__ import annotations

import numpy as np

from openpose_tpu_torch.threed.triangulation import reconstruct_array
from openpose_tpu_torch.wrapper import PoseConfig, Wrapper


def multiview_3d(images, cameras, pose=None, device=None):
    """The 3-D people of one frame: images, one BGR image a view; cameras
    [views, 3, 4], each view's K[R|t].  Returns (the `Wrapper`, the 3-D
    keypoints [people, parts, 4])."""
    wrapper = Wrapper(pose=pose or PoseConfig(), device=device)
    datums = [wrapper.process(image) for image in images]
    sizes = [(image.shape[1], image.shape[0]) for image in images]
    kp3d = reconstruct_array([d.pose_keypoints for d in datums],
                             np.asarray(cameras, np.float32), sizes,
                             device=wrapper.device)
    print("3D keypoints:", kp3d.shape)
    return wrapper, kp3d


if __name__ == "__main__":
    import argparse

    from openpose_tpu_torch.io.producers import (ImageDirectoryReader,
                                                 ProducerConfig)
    from openpose_tpu_torch.render.gui3d import render_skeleton_3d
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image_dir")
    ap.add_argument("camera_dir")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    reader = ImageDirectoryReader(args.image_dir, ProducerConfig(
        num_views=2, camera_parameter_path=args.camera_dir))
    for views in reader.frames():
        wrapper, kp3d = multiview_3d(
            [f.image for f in views],
            np.stack([f.camera.full_matrix for f in views]),
            device="cpu" if args.cpu else None)
        render_skeleton_3d(kp3d, wrapper.pose_cfg.model,
                           out_path="skeleton3d.png")
        break
