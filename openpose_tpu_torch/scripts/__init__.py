"""The user scripts on the port: counterparts of the repository's
`scripts/synthetic_eval.py`, `threed_eval.py`, `train_to_ap.py`,
`fetch_models.py` and `coco_val.py`, with the same flags, run as
`python -m openpose_tpu_torch.scripts.<name>`.  Each runs on the card
unless `--cpu` is given (`coco_val.main` takes a `device`), and raises
where no card is found."""
