"""The benchmark of human_pose_tpu_torch on an NVIDIA H100; see run.py."""
