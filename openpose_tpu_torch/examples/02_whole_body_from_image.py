"""Tutorial 02: body + face + hands (reference tutorial 06/07 equivalents).

    python -m openpose_tpu_torch.examples.02_whole_body_from_image \\
        image.jpg [--cpu]

writes the rendered keypoints to rendered_whole_body.png.
"""

from __future__ import annotations

from openpose_tpu_torch.wrapper import (FaceConfig, HandConfig, PoseConfig,
                                        Wrapper)


def whole_body_from_image(image, pose=None, face=None, hand=None,
                          device=None):
    """Body, face and hand keypoints of one BGR image: (the `Wrapper`, its
    `Datum`).  face and hand default to enabled configs."""
    wrapper = Wrapper(pose=pose or PoseConfig(),
                      face=face or FaceConfig(enable=True),
                      hand=hand or HandConfig(enable=True), device=device)
    datum = wrapper.process(image)
    print("pose:", None if datum.pose_keypoints is None
          else datum.pose_keypoints.shape)
    print("face:", None if datum.face_keypoints is None
          else datum.face_keypoints.shape)
    print("hands:", None if datum.hand_left_keypoints is None else
          (datum.hand_left_keypoints.shape, datum.hand_right_keypoints.shape))
    return wrapper, datum


if __name__ == "__main__":
    import argparse

    import cv2
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?", default="image.jpg")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    wrapper, datum = whole_body_from_image(
        cv2.imread(args.image), device="cpu" if args.cpu else None)
    cv2.imwrite("rendered_whole_body.png", wrapper.render(datum))
