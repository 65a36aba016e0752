"""Tutorial 03: access + visualize network heatmaps (reference tutorials
04_keypoints_from_images / 09_keypoints_from_heatmaps equivalents).

    python -m openpose_tpu_torch.examples.03_heatmaps_from_image \\
        image.jpg [--cpu]

writes the heatmaps over the image to heatmaps.png.
"""

from __future__ import annotations

from openpose_tpu_torch.wrapper import PoseConfig, Wrapper


def heatmaps_from_image(image, pose=None, device=None):
    """The pose extractor's prediction of one BGR image with its merged
    net-scale heatmaps [H, W, channels] (`pred.heatmaps`), at the
    config's net resolution."""
    wrapper = Wrapper(pose=pose or PoseConfig(), device=device)
    pred = wrapper.pose_extractor.forward(
        image, net_resolution=wrapper.pose_cfg.net_resolution,
        keep_heatmaps=True)
    print("heatmaps:", pred.heatmaps.shape)
    return pred


if __name__ == "__main__":
    import argparse

    import cv2
    from openpose_tpu_torch.render import heatmaps as hm
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?", default="image.jpg")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    image = cv2.imread(args.image)
    pred = heatmaps_from_image(image, device="cpu" if args.cpu else None)
    cv2.imwrite("heatmaps.png",
                hm.overlay_heatmap(image.copy(), pred.heatmaps, part=-1))
