"""Tutorial 01: body keypoints from one image (reference tutorial
examples/tutorial_api_python/01_body_from_image.py equivalent).

    python -m openpose_tpu_torch.examples.01_body_from_image image.jpg [--cpu]

writes the rendered skeletons to rendered.png.
"""

from __future__ import annotations

from openpose_tpu_torch.wrapper import PoseConfig, Wrapper


def body_from_image(image, pose=None, device=None):
    """The people of one BGR image: (the `Wrapper`, its `Datum`).  pose: a
    `PoseConfig` (add caffemodel="weights.npz" for real weights)."""
    wrapper = Wrapper(pose=pose or PoseConfig(), device=device)
    datum = wrapper.process(image)
    print("Body keypoints:\n", datum.pose_keypoints)
    return wrapper, datum


if __name__ == "__main__":
    import argparse

    import cv2
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?", default="image.jpg")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    wrapper, datum = body_from_image(cv2.imread(args.image),
                                     device="cpu" if args.cpu else None)
    cv2.imwrite("rendered.png", wrapper.render(datum))
