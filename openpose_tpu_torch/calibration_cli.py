"""Calibration toolbox CLI — the reference `calibration.bin`
(examples/calibration/calibration.cpp) flag surface over
openpose_tpu_torch.threed.calibration.

Mode 1 (intrinsics): chessboard images of one camera -> K + distortion,
saved as a reference-format XML into --camera_parameter_folder.

Mode 2 (extrinsics): simultaneous chessboard image pairs of cam0/cam1 (both
already intrinsically calibrated) -> relative [R|t] of cam1 w.r.t. cam0,
averaged over all valid pairs, written back into cam1's XML.

Example:
    python -m openpose_tpu_torch.calibration_cli --mode 1 \
        --calibration_image_dir imgs/intrinsics_cam0 \
        --camera_serial_number cam0 --grid_number_inner_corners 9x6 \
        --grid_square_size_mm 127 --camera_parameter_folder params/

The port's copy of `openpose_tpu/calibration_cli.py` over the port's own
`threed.calibration`, `threed.visualsfm` and `threed.camera`.  OpenCV is
imported where images are read and boards found: `--help` runs without
it, and modes 1, 2 and 4 stop there with an ImportError naming OpenCV.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="openpose_tpu_torch.calibration_cli",
        description="camera calibration toolbox (intrinsics / extrinsics)")
    p.add_argument("--mode", type=int, default=1,
                   help="1 = intrinsics, 2 = extrinsics, 4 = VisualSFM "
                        "SIFT export (calibration.cpp)")
    p.add_argument("--number_cameras", type=int, default=4,
                   help="mode 4: cameras per view (calibration.cpp:32)")
    p.add_argument("--calibration_image_dir", default="images/intrinsics/")
    p.add_argument("--grid_square_size_mm", type=float, default=127.0)
    p.add_argument("--grid_number_inner_corners", default="9x6")
    p.add_argument("--camera_serial_number", default="camera0",
                   help="mode 1: serial for the output XML / filename filter")
    p.add_argument("--camera_parameter_folder", default="cameraParameters/")
    p.add_argument("--cam0", default="", help="mode 2: base camera serial")
    p.add_argument("--cam1", default="", help="mode 2: target camera serial")
    p.add_argument("--omit_distortion", action="store_true")
    return p


def _load_images(directory: str, name_filter: str = ""):
    from openpose_tpu_torch.threed.calibration import opencv
    cv2 = opencv()
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    paths = sorted(p for p in pathlib.Path(directory).iterdir()
                   if p.suffix.lower() in exts
                   and (not name_filter or name_filter in p.name))
    return paths, [cv2.imread(str(p)) for p in paths]


def _mean_rigid(transforms):
    """Average [R|t] transforms: SVD-projected mean rotation + mean t."""
    rs = np.stack([m[:3, :3] for m in transforms])
    ts = np.stack([m[:3, 3] for m in transforms])
    u, _, vt = np.linalg.svd(rs.mean(axis=0))
    r = u @ vt
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1
        r = u @ vt
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = ts.mean(axis=0)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from openpose_tpu_torch.threed import calibration as calib
    from openpose_tpu_torch.threed.camera import (CameraParameters,
                                                  read_camera_xml,
                                                  write_camera_xml)
    cols, rows = (int(v) for v in args.grid_number_inner_corners
                  .lower().split("x"))
    grid = (cols, rows)
    out_dir = pathlib.Path(args.camera_parameter_folder)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.mode == 1:
        paths, images = _load_images(args.calibration_image_dir)
        if not images:
            raise SystemExit(
                f"no images in {args.calibration_image_dir}")
        params, rms = calib.estimate_intrinsics(
            images, grid, args.grid_square_size_mm,
            serial=args.camera_serial_number)
        if args.omit_distortion:
            params.distortion[:] = 0.0
        out = out_dir / f"{args.camera_serial_number}.xml"
        write_camera_xml(str(out), params)
        print(f"intrinsics from {len(images)} images "
              f"(RMS reprojection {rms:.3f} px) -> {out}")
        return 0

    if args.mode == 2:
        if not args.cam0 or not args.cam1:
            raise SystemExit("mode 2 needs --cam0 and --cam1 serials")
        base = read_camera_xml(str(out_dir / f"{args.cam0}.xml"))
        target = read_camera_xml(str(out_dir / f"{args.cam1}.xml"))
        paths0, imgs0 = _load_images(args.calibration_image_dir, args.cam0)
        paths1, imgs1 = _load_images(args.calibration_image_dir, args.cam1)
        if len(imgs0) != len(imgs1) or not imgs0:
            raise SystemExit(
                f"need matched simultaneous pairs; got {len(imgs0)} images "
                f"for {args.cam0} and {len(imgs1)} for {args.cam1}")
        rels = []
        for p0, i0, p1, i1 in zip(paths0, imgs0, paths1, imgs1):
            try:
                rel = calib.estimate_extrinsics(
                    base, target, i0, i1, grid, args.grid_square_size_mm)
            except ValueError as e:
                print(f"skipping pair {p0.name}/{p1.name}: {e}",
                      file=sys.stderr)
                continue
            m = np.eye(4)
            m[:3, :] = rel
            rels.append(m)
        if not rels:
            raise SystemExit("chessboard not found in any image pair")
        mean = _mean_rigid(rels)[:3, :]
        target = CameraParameters(
            serial=target.serial, camera_matrix=mean,
            intrinsics=target.intrinsics, distortion=target.distortion)
        out = out_dir / f"{args.cam1}.xml"
        write_camera_xml(str(out), target)
        print(f"extrinsics of {args.cam1} w.r.t. {args.cam0} from "
              f"{len(rels)} pairs -> {out}")
        return 0

    if args.mode == 4:
        # VisualSFM/SiftGPU export of chessboard correspondences
        # (estimateAndSaveSiftFile, cameraParameterEstimation.cpp:2340-2420)
        from openpose_tpu_torch.threed import visualsfm
        report = visualsfm.estimate_and_save_sift_files(
            grid, args.calibration_image_dir, args.number_cameras)
        print(f"{report['n_views']} views x {args.number_cameras} cameras: "
              f"boards found per camera {report['found']}; wrote "
              f"{len(report['sift_files'])} .sift files + "
              f"{report['matches_file']}")
        return 0

    raise SystemExit(f"unsupported --mode {args.mode} (1, 2 or 4)")


if __name__ == "__main__":
    sys.exit(main())
