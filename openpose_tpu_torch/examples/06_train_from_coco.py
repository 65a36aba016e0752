"""Tutorial 06: train the BODY_25 CNN on COCO keypoints (beyond the
reference, which defers training to the separate openpose_train repo).

    python -m openpose_tpu_torch.examples.06_train_from_coco images/ \\
        person_keypoints.json [--cpu]

Reading the COCO images needs OpenCV.
"""

from __future__ import annotations

from openpose_tpu_torch.train_loop import (TrainConfig, coco_data_iterator,
                                           train)


def train_from_coco(images_dir, annotations, config=None, device=None):
    """Train on the COCO images and annotations; the final `TrainState`
    (checkpoints in `config.checkpoint_dir`)."""
    config = config or TrainConfig(steps=1000, batch_size=8)
    data = coco_data_iterator(images_dir, annotations, config)
    return train(config, data, device=device)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("images_dir")
    ap.add_argument("annotations")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    train_from_coco(args.images_dir, args.annotations,
                    device="cpu" if args.cpu else None)
