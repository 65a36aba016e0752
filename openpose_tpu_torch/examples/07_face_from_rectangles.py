"""Tutorial 07: face keypoints from user-supplied face rectangles, body
disabled (reference python tutorial 06_face_from_image.py: faceRectangles
passed in, --body 0 --face).

    python -m openpose_tpu_torch.examples.07_face_from_rectangles \\
        image.jpg [--cpu]

writes the rendered faces to rendered_faces.png.
"""

from __future__ import annotations

import numpy as np
import torch

from openpose_tpu_torch.face.extractor import FaceExtractor
from openpose_tpu_torch.models import zoo

# (x, y, width, height) boxes, e.g. from an external face detector
FACE_RECTANGLES = [
    (330.0, 77.0, 153.0, 153.0),
    (24.0, 267.0, 165.0, 165.0),
]


def face_from_rectangles(image, face_rectangles=FACE_RECTANGLES,
                         caffemodel=None, net_size=368, device=None):
    """Face keypoints [n_faces, 70, 3] of one BGR image inside the given
    rectangles, in float32; caffemodel: the face net's weights (random
    when None)."""
    extractor = FaceExtractor(
        zoo.load_face_model(device=device, caffemodel=caffemodel),
        net_size=net_size, compute_dtype=torch.float32, device=device)
    face_keypoints = extractor.forward(np.asarray(image, np.float32),
                                       face_rectangles)
    print("face keypoints:", face_keypoints.shape)
    return face_keypoints


if __name__ == "__main__":
    import argparse

    import cv2
    from openpose_tpu_torch.render.render import render_face
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?", default="image.jpg")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    image = cv2.imread(args.image)
    face_keypoints = face_from_rectangles(
        image, device="cpu" if args.cpu else None)
    cv2.imwrite("rendered_faces.png",
                render_face(image.copy(), face_keypoints))
