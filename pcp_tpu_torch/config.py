"""YAML experiment configuration: the port's own copy of ``pcp_tpu/config.py``.

The configs under ``tools/cfgs/`` are shared by both packages. ``CfgDict`` is
an attribute dict; ``cfg_from_yaml_file`` merges a YAML file into it and
resolves ``_BASE_CONFIG_`` includes (loaded first, then overridden by their
sibling keys), accepting paths relative to the repository root, the including
file, or ``tools/`` as the reference writes them. ``cfg_from_list`` applies
the CLIs' ``--set KEY.SUBKEY value`` pairs.
"""
import ast
import copy
from pathlib import Path

import yaml

ROOT_DIR = Path(__file__).resolve().parent.parent


class CfgDict(dict):
    """A dict whose items are also accessible as attributes, recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        for k, v in dict(d or {}, **kwargs).items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, CfgDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, self._wrap(value))

    def __deepcopy__(self, memo):
        return CfgDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def merge_new_config(config, new_config):
    """Merge ``new_config`` into ``config`` recursively, loading a
    ``_BASE_CONFIG_`` include first."""
    if "_BASE_CONFIG_" in new_config:
        with open(new_config["_BASE_CONFIG_"], "r") as f:
            config.update(CfgDict(yaml.safe_load(f)))
    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if not isinstance(config.get(key), dict):
                config[key] = CfgDict()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config):
    with open(cfg_file, "r") as f:
        new_config = yaml.safe_load(f)
    _resolve_bases(new_config, cfg_file)
    return merge_new_config(config=config, new_config=new_config)


def _resolve_base(base, cfg_file):
    if Path(base).exists():
        return str(base)
    here = Path(cfg_file).resolve().parent
    for root in (here, here.parent, here.parent.parent, ROOT_DIR):
        for rel in (str(base), str(base).lstrip("./")):
            cand = (root / rel).resolve()
            if cand.exists():
                return str(cand)
    stripped = str(base)
    while stripped.startswith("../"):
        stripped = stripped[3:]
    cand = ROOT_DIR / stripped
    return str(cand) if cand.exists() else str(base)


def _resolve_bases(node, cfg_file):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "_BASE_CONFIG_":
                node[k] = _resolve_base(v, cfg_file)
            else:
                _resolve_bases(v, cfg_file)
    elif isinstance(node, list):
        for v in node:
            _resolve_bases(v, cfg_file)


def cfg_from_list(cfg_list, config):
    """Apply dotted overrides, e.g. ``['MODEL.VFE.NUM_FILTERS', '[64]']``. A
    value is read with ``ast.literal_eval`` where it parses, else kept as a
    string. A new key is added; a dict value is merged into the dict it
    replaces; any other value must keep the type of the one it replaces
    (or either side is None)."""
    assert len(cfg_list) % 2 == 0, "--set expects KEY VALUE pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, "NotFoundKey: %s" % subkey
            d = d[subkey]
        subkey = key_list[-1]
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if subkey not in d:
            d[subkey] = value
        elif isinstance(value, dict):
            for sk, sv in value.items():
                d[subkey][sk] = sv
        else:
            assert type(value) == type(d[subkey]) or d[subkey] is None or value is None, (
                "type mismatch for %s: %s vs %s" % (full_key, type(value), type(d[subkey])))
            d[subkey] = value
    return config


def log_config_to_file(cfg, pre="cfg", logger=None):
    """Log every leaf of ``cfg`` as ``pre.KEY.SUBKEY: value``."""
    for key, val in cfg.items():
        if isinstance(val, CfgDict):
            if logger is not None:
                logger.info("----------- %s.%s -----------" % (pre, key))
            log_config_to_file(val, pre=pre + "." + key, logger=logger)
        elif logger is not None:
            logger.info("%s.%s: %s" % (pre, key, val))
