"""Training of the port: counterpart of ``pcp_tpu/train`` (optimizers and
schedules, train state and steps, the loop, ``.pth`` checkpoints, BN
recalibration)."""
