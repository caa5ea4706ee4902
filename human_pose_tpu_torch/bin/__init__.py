"""Command-line entry points of the port (``python -m human_pose_tpu_torch.bin.<name>``)."""
