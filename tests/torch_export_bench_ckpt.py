"""Export the committed trained ego checkpoint for the PyTorch port.

``results/bench_ckpt`` is an orbax checkpoint of the flagship lately-fusion
ego (``v2x_pointpillar_basic_ego.yaml``). This script reads it with the JAX
package's ``load_params_from_file``, maps it to pcdet names with
``pcp_tpu_torch/utils/jax_weights.py::state_dict_from_jax_variables`` and
writes ``results/bench_ckpt_torch.pt``: a float32 state dict that
``torch.load(..., weights_only=True)`` reads and the port's ego loads with
``strict=True``, on a machine without jax or orbax.

    JAX_PLATFORMS=cpu python tests/torch_export_bench_ckpt.py

It imports jax, so it lives beside the tests and not in the port's package.
``tests/test_torch_bench_ckpt.py`` holds the committed file equal to a fresh
export.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "results" / "bench_ckpt"
TARGET = REPO / "results" / "bench_ckpt_torch.pt"


def export_state_dict():
    """The orbax checkpoint as the port's state dict (CPU tensors)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from pcp_tpu.train.checkpoint import load_params_from_file
    from pcp_tpu_torch.config import CfgDict, cfg_from_yaml_file
    from pcp_tpu_torch.entry import CFG_EGO
    from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables

    cfg = cfg_from_yaml_file(REPO / CFG_EGO, CfgDict())
    variables = jax.tree_util.tree_map(np.asarray, load_params_from_file(str(SOURCE)))
    return state_dict_from_jax_variables(variables, cfg.MODEL)


def main():
    sd = export_state_dict()
    torch.save(sd, TARGET)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {TARGET.relative_to(REPO)}: {len(sd)} tensors, {n} values, "
          f"{TARGET.stat().st_size} bytes")


if __name__ == "__main__":
    main()
