"""Tutorial 08: hand keypoints from user-supplied hand rectangles, body
disabled (reference python tutorial 07_hand_from_image.py: handRectangles
passed in as [left, right] pairs, --body 0 --hand).

    python -m openpose_tpu_torch.examples.08_hand_from_rectangles \\
        image.jpg [--cpu]

writes the rendered hands to rendered_hands.png.
"""

from __future__ import annotations

import numpy as np
import torch

from openpose_tpu_torch.hand.extractor import HandExtractor
from openpose_tpu_torch.models import zoo

# One (left, right) rectangle pair per person, (x, y, width, height);
# a zero-size rectangle skips that hand (like the reference's empty Rect).
HAND_RECTANGLES = [
    ((320.0, 377.0, 70.0, 70.0),      # person 0 left hand
     (80.0, 407.0, 80.0, 80.0)),      # person 0 right hand
    ((0.0, 0.0, 0.0, 0.0),            # person 1: left hand not visible
     (190.0, 80.0, 100.0, 100.0)),
]


def hand_from_rectangles(image, hand_rectangles=HAND_RECTANGLES,
                         caffemodel=None, net_size=368, device=None):
    """(left, right) hand keypoints [people, 21, 3] of one BGR image inside
    the given rectangle pairs, in float32; caffemodel: the hand net's
    weights (random when None)."""
    extractor = HandExtractor(
        zoo.load_hand_model(device=device, caffemodel=caffemodel),
        net_size=net_size, compute_dtype=torch.float32, device=device)
    left, right = extractor.forward(np.asarray(image, np.float32),
                                    hand_rectangles)
    print("left hands:", left.shape, " right hands:", right.shape)
    return left, right


if __name__ == "__main__":
    import argparse

    import cv2
    from openpose_tpu_torch.render.render import render_hands
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?", default="image.jpg")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    image = cv2.imread(args.image)
    left, right = hand_from_rectangles(image,
                                       device="cpu" if args.cpu else None)
    cv2.imwrite("rendered_hands.png",
                render_hands(image.copy(), left, right))
