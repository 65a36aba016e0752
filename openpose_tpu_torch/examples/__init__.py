"""The nine tutorials on the port: counterparts of the repository's
`examples/01_*.py` to `09_*.py`.  Each puts its work in a function that
takes the image or frames and a `device` (the card when None) and returns
what it printed; only its `__main__` block reads files (with OpenCV) and
writes the rendered images.  Run one as

    python -m openpose_tpu_torch.examples.01_body_from_image image.jpg

and add `--cpu` to run it on the CPU."""
