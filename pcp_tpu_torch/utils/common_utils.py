"""Runtime helpers of the CLIs and datasets: logging, seeding, name filters.

Counterpart of ``pcp_tpu/utils/common_utils.py:13-60``; the seed also seeds
torch.
"""
import logging
import os
import random

import numpy as np
import torch


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """A logger to the console and, with ``log_file``, to that file. One
    logger per (rank, file); asking again returns it unchanged."""
    logger = logging.getLogger(f"pcp_tpu_torch.r{rank}.{log_file}")
    level = log_level if rank == 0 else logging.ERROR
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    handlers = [logging.StreamHandler()]
    if log_file is not None:
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setLevel(level)
        h.setFormatter(formatter)
        logger.addHandler(h)
    return logger


def set_random_seed(seed):
    """Seed python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def keep_arrays_by_name(gt_names, used_classes):
    """Indices (int64) of the names in ``used_classes``, in order."""
    return np.array([i for i, x in enumerate(gt_names) if x in used_classes], dtype=np.int64)


def drop_info_with_name(info, name):
    """``info`` without the rows whose ``info["name"]`` is ``name``: every
    array with one row per name is filtered, other values are kept."""
    ret = {}
    keep = [i for i, x in enumerate(info["name"]) if x != name]
    for key, val in info.items():
        if isinstance(val, np.ndarray) and val.shape[0] == len(info["name"]):
            ret[key] = val[keep]
        else:
            ret[key] = val
    ret["name"] = (info["name"][keep] if isinstance(info["name"], np.ndarray)
                   else [info["name"][i] for i in keep])
    return ret
