"""Fetch the CMU trained caffemodels and convert them to native .npz, on
the port.

Counterpart of the repository's `scripts/fetch_models.py` (a copy, not an
import: the checksum table and the fetch are the original's), mirroring
the reference's CMake download step (CMakeLists.txt:985-994:
download_model(<name> <on> <path> <md5>) against DOWNLOAD_SERVER
http://posefs1.perception.cs.cmu.edu/OpenPose/models/).  The conversion
goes through the port's caffemodel parser and writes the checkpoint
`.npz` that both packages load (`models/checkpoint.py`).  After this
script succeeds, `--model_folder <dest>` works for the raw caffemodel
(`zoo.resolve_caffemodel`), and `--caffemodel_path <dest>/...npz` for the
converted checkpoint.

Usage:
    python -m openpose_tpu_torch.scripts.fetch_models --dest models/ \\
        [--only body_25 face]
    python -m openpose_tpu_torch.scripts.fetch_models --dest models/ \\
        --server http://mirror/...

Offline environments: pass `--from-dir <dir>` holding already-downloaded
caffemodels (same relative layout); the script then only verifies checksums
and converts.  Download failures name every missing file so the transfer can
be done out of band.  Nothing here needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys
import urllib.request

DEFAULT_SERVER = "http://posefs1.perception.cs.cmu.edu/OpenPose/models/"

# name -> (relative path, md5, spec name for npz conversion)
# CMakeLists.txt:985-994; spec names match openpose_tpu_torch/models/specs.
MODELS = {
    "body_25": ("pose/body_25/pose_iter_584000.caffemodel",
                "78287b57cf85fa89c03f1393d368e5b7", "body_25"),
    "coco_18": ("pose/coco/pose_iter_440000.caffemodel",
                "5156d31f670511fce9b4e28b403f2939", "coco_18"),
    "mpi_15": ("pose/mpi/pose_iter_160000.caffemodel",
               "2ca0990c7562bd7ae03f3f54afa96e00", "mpi_15"),
    "face": ("face/pose_iter_116000.caffemodel",
             "e747180d728fa4e4418c465828384333", "face_70"),
    "hand": ("hand/pose_iter_102000.caffemodel",
             "a82cfc3fea7c62f159e11bd3674c1531", "hand_21"),
}


def md5_of(path: pathlib.Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch_one(name: str, dest: pathlib.Path, server: str,
              from_dir: pathlib.Path | None = None,
              opener=urllib.request.urlopen,
              verify_md5: bool = True) -> pathlib.Path:
    """Download (or copy from `from_dir`) + verify one caffemodel.

    Returns the local caffemodel path.  Raises FileNotFoundError /
    ValueError (checksum) on failure.
    """
    rel, md5, _spec = MODELS[name]
    out = dest / rel
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists() and (not verify_md5 or md5_of(out) == md5):
        return out
    if from_dir is not None:
        src = from_dir / rel
        if not src.exists():
            raise FileNotFoundError(f"{name}: {src} not found (offline mode)")
        out.write_bytes(src.read_bytes())
    else:
        url = server.rstrip("/") + "/" + rel
        with opener(url) as resp:
            out.write_bytes(resp.read())
    if verify_md5:
        got = md5_of(out)
        if got != md5:
            out.unlink()
            raise ValueError(f"{name}: MD5 mismatch (got {got}, want {md5})")
    return out


def convert_one(name: str, caffemodel: pathlib.Path) -> pathlib.Path:
    """The caffemodel as the checkpoint `.npz` beside it (HWIO weights,
    keys "layer/key"); its path."""
    from openpose_tpu_torch.models import caffe_proto, checkpoint, graph
    _rel, _md5, spec = MODELS[name]
    npz = caffemodel.with_suffix(".npz")
    blobs = caffe_proto.parse_caffemodel(caffemodel.read_bytes())
    checkpoint.save(str(npz), graph.convert_caffe_blobs(
        graph.load_spec(spec), blobs))
    return npz


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dest", default="models",
                    help="destination model folder (reference layout)")
    ap.add_argument("--only", nargs="*", choices=sorted(MODELS),
                    help="subset of models (default: all)")
    ap.add_argument("--server", default=DEFAULT_SERVER)
    ap.add_argument("--from-dir", default=None,
                    help="offline: copy caffemodels from this dir instead "
                         "of downloading")
    ap.add_argument("--no-convert", action="store_true",
                    help="skip the .npz conversion step")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip MD5 verification (mirrors with newer weights)")
    args = ap.parse_args(argv)

    dest = pathlib.Path(args.dest)
    from_dir = pathlib.Path(args.from_dir) if args.from_dir else None
    names = args.only or sorted(MODELS)
    failures = []
    for name in names:
        try:
            cm = fetch_one(name, dest, args.server, from_dir=from_dir,
                           verify_md5=not args.no_verify)
            print(f"[fetch_models] {name}: {cm} OK")
            if not args.no_convert:
                npz = convert_one(name, cm)
                print(f"[fetch_models] {name}: converted -> {npz}")
        except Exception as e:  # noqa: BLE001 - report all, then fail
            failures.append((name, e))
            print(f"[fetch_models] {name}: FAILED ({e})", file=sys.stderr)
    if failures:
        print(f"[fetch_models] {len(failures)}/{len(names)} failed; "
              "use --from-dir with out-of-band downloads if offline",
              file=sys.stderr)
        return 1
    print(f"[fetch_models] all {len(names)} models ready under {dest}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
