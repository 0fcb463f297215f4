"""pcp_tpu_torch: the PyTorch / CUDA port of pcp_tpu for NVIDIA Hopper GPUs.

The lately-fusion ego CenterPoint: its serving forward (``entry.build``) and
its training (``train/``).
Importing the package builds nothing and needs no GPU.
"""
