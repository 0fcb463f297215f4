"""JAX (flax) variables -> the port's state dict.

The inverse of ``pcp_tpu/utils/torch_converter.py::convert_centerpoint_state_dict``
for the pillar CenterPoint and its HunterJr corrector (conv_input, the point
head, the object head where the variables have one, the weightor), and for
DiscoNet: the frozen BEV makers ``bev_maker_{rsu,car,early}`` and the
distillation ``teacher`` (each a VFE and a backbone, under the pcdet names
of the single-agent detector with the maker's prefix:
``bev_maker_car.vfe.pfn_layers.0.linear.weight``,
``bev_maker_car.backbone_2d.blocks.0.1.weight``, ...) and the mid fusion,
whose names are the JAX package's module names
(``v2x_mid_fusion.compressor.conv0``, ``...compressor.bn0``,
``...pixel_weightor.conv1_1``, ``...pixel_weightor.bn1_1``,
``...decompressor.conv1``, ...): the reference's own state-dict names for
DiscoNet are not at hand. It takes ``{'params', 'batch_stats'}`` as numpy
arrays and returns tensors under those names, ready for
``load_state_dict(strict=True)``. :func:`tensors_from_jax_params` maps any
tree shaped like ``params`` the same way (gradients, adam_onecycle's ``mu``
and ``nu``) onto the parameters' names, so training state can be held leaf
by leaf against the JAX package's.

  * Dense kernel (in, out)          -> Linear weight (out, in)
  * Conv kernel (kh, kw, in, out)   -> Conv2d weight (out, in, kh, kw)
  * ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight
    (in, out, kh, kw), flipped spatially (flax does not flip, torch does)
  * BatchNorm scale/bias, mean/var  -> weight/bias, running_mean/running_var
    (num_batches_tracked 0)
  * MLP ``lin_{i}`` / ``norm_{i}``     -> pcdet's Sequential, Linear at 3i,
    BN at 3i+1
"""
import numpy as np
import torch


def _tensor(x):
    return torch.from_numpy(np.array(x, order="C", copy=True))


def _linear(k):
    return _tensor(np.asarray(k).T)


def _conv(k):
    return _tensor(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _deconv(k):
    return _tensor(np.transpose(np.asarray(k), (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _put_bn(sd, prefix, params, stats):
    sd[f"{prefix}.weight"] = _tensor(params["scale"])
    sd[f"{prefix}.bias"] = _tensor(params["bias"])
    if stats is None:  # a params-shaped tree: no running statistics
        return
    sd[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    sd[f"{prefix}.running_var"] = _tensor(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _put_conv(sd, prefix, params, to_weight=_conv):
    sd[f"{prefix}.weight"] = to_weight(params["kernel"])
    if "bias" in params:
        sd[f"{prefix}.bias"] = _tensor(params["bias"])


def state_dict_from_jax_variables(variables, model_cfg):
    """Map flax ``variables`` of a pillar CenterPoint built from ``model_cfg``
    (the MODEL config) to a pcdet-named state dict of tensors. Sub-modules
    whose key (BEV_MAKER_*, TEACHER, VFE, BACKBONE_2D, CORRECTOR,
    V2X_MID_FUSION, DENSE_HEAD) the config lacks, or whose subtree the
    variables lack (an eval-mode init never calls the early maker or the
    teacher), are skipped."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd = {}
    for key in ("BEV_MAKER_RSU", "BEV_MAKER_CAR", "BEV_MAKER_EARLY", "TEACHER"):
        name = key.lower()
        if model_cfg.get(key) is not None and name in params:
            _single_agent(sd, params[name], _sub(stats, name), model_cfg[key], f"{name}.")
    _single_agent(sd, params, stats, model_cfg)
    if "CORRECTOR" in model_cfg and model_cfg["CORRECTOR"]["NAME"] == "HunterJr":
        _corrector(sd, params["corrector"], _sub(stats, "corrector"))
    if model_cfg.get("V2X_MID_FUSION") is not None and "v2x_mid_fusion" in params:
        _disco(sd, params["v2x_mid_fusion"], _sub(stats, "v2x_mid_fusion"))
    if "DENSE_HEAD" in model_cfg:
        _head(sd, params["dense_head"], _sub(stats, "dense_head"), model_cfg["DENSE_HEAD"])
    return sd


def tensors_from_jax_params(tree, model_cfg):
    """A tree shaped like flax ``params`` (gradients, optimizer moments) as
    tensors under the names of the parameters they belong to; kernels are
    transposed and flipped as the weights are."""
    return state_dict_from_jax_variables({"params": tree}, model_cfg)


def _sub(stats, key):
    """The sub-tree of ``stats`` at ``key``; None all the way down when
    there are no statistics."""
    return None if stats is None else stats.get(key, {})


def _single_agent(sd, params, stats, cfg, prefix=""):
    """The VFE and the backbone of a single-agent network, under ``prefix``."""
    if "VFE" in cfg:
        _vfe(sd, params["vfe"], _sub(stats, "vfe"), cfg["VFE"], prefix)
    if "BACKBONE_2D" in cfg:
        _backbone(sd, params["backbone_2d"], _sub(stats, "backbone_2d"), cfg["BACKBONE_2D"], prefix)


def _vfe(sd, vfe_p, vfe_s, vcfg, prefix=""):
    for i in range(len(list(vcfg["NUM_FILTERS"]))):
        p, base = vfe_p[f"pfn_{i}"], f"{prefix}vfe.pfn_layers.{i}"
        sd[f"{base}.linear.weight"] = _linear(p["linear"]["kernel"])
        if "bias" in p["linear"]:
            sd[f"{base}.linear.bias"] = _tensor(p["linear"]["bias"])
        if "norm" in p:
            _put_bn(sd, f"{base}.norm", p["norm"], _sub(_sub(vfe_s, f"pfn_{i}"), "norm"))


def _backbone(sd, bb_p, bb_s, bcfg, prefix=""):
    """The backbone's blocks; a block without ``norm`` (``fold_bn_variables``'s
    output) is a biased conv, whose BN slot holds no tensor. Packed kernels
    (``w_pack_variables``) map as any other."""
    def put_bn(key, blk):
        if "norm" in bb_p[blk]:
            _put_bn(sd, key, bb_p[blk]["norm"], _sub(_sub(bb_s, blk), "norm"))

    for l, n_layers in enumerate(list(bcfg["LAYER_NUMS"])):
        for k in range(n_layers + 1):
            blk, base = f"block{l}_{k}", f"{prefix}backbone_2d.blocks.{l}"
            _put_conv(sd, f"{base}.{3 * k + 1}", bb_p[blk]["conv"])
            put_bn(f"{base}.{3 * k + 2}", blk)
        blk, base = f"deblock{l}", f"{prefix}backbone_2d.deblocks.{l}"
        if blk in bb_p:
            if "deconv" in bb_p[blk]:
                _put_conv(sd, f"{base}.0", bb_p[blk]["deconv"], _deconv)
            else:
                _put_conv(sd, f"{base}.0", bb_p[blk]["conv"])
            put_bn(f"{base}.1", blk)


def _head(sd, hd_p, hd_s, hcfg):
    _put_conv(sd, "dense_head.shared_conv.0", hd_p["shared_conv"])
    _put_bn(sd, "dense_head.shared_conv.1", hd_p["shared_norm"], _sub(hd_s, "shared_norm"))
    head_dict = hcfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"]
    for h in range(len(hcfg["CLASS_NAMES_EACH_HEAD"])):
        hp, hs = hd_p[f"head_{h}"], _sub(hd_s, f"head_{h}")
        for name in list(head_dict) + ["hm"]:
            num_conv = int(hcfg["NUM_HM_CONV"] if name == "hm" else head_dict[name]["num_conv"])
            base = f"dense_head.heads_list.{h}.{name}"
            for k in range(num_conv - 1):
                _put_conv(sd, f"{base}.{k}.0", hp[f"{name}_conv{k}"])
                _put_bn(sd, f"{base}.{k}.1", hp[f"{name}_norm{k}"], _sub(hs, f"{name}_norm{k}"))
            _put_conv(sd, f"{base}.{num_conv - 1}", hp[f"{name}_out"])


def _corrector(sd, cp, cs):
    _put_conv(sd, "corrector.conv_input.0", cp["conv_input"]["conv"])
    _put_bn(sd, "corrector.conv_input.1", cp["conv_input"]["norm"],
            _sub(_sub(cs, "conv_input"), "norm"))
    for name in ("local_feat_predictor", "seg", "reg_flow3d", "instance_embedding"):
        put_mlp(sd, f"corrector.point_head.{name}", cp["point_head"][name],
                _sub(_sub(cs, "point_head"), name))
    # a JAX init in eval mode never calls the object head, so eval-only
    # variables have none; the port's object head then keeps its own weights
    for name in ("points_shape_encoder", "local_feat_encoder", "local_tf_decoder"):
        if name in cp.get("object_head", {}):
            put_mlp(sd, f"corrector.object_head.{name}", cp["object_head"][name],
                    _sub(_sub(cs, "object_head"), name))
    _put_conv(sd, "corrector.conv_weightor.0.0", cp["weightor_conv"]["conv"])
    _put_bn(sd, "corrector.conv_weightor.0.1", cp["weightor_conv"]["norm"],
            _sub(_sub(cs, "weightor_conv"), "norm"))
    _put_conv(sd, "corrector.conv_weightor.1", cp["weightor_out"])


def _disco(sd, fp, fs):
    for block, names in (("compressor", (("conv0", "bn0"), ("conv1", None))),
                         ("decompressor", (("conv0", "bn0"), ("conv1", None))),
                         ("pixel_weightor", (("conv1_1", "bn1_1"), ("conv1_2", "bn1_2"),
                                             ("conv1_4", None)))):
        for conv, bn in names:
            _put_conv(sd, f"v2x_mid_fusion.{block}.{conv}", fp[block][conv])
            if bn is not None:
                _put_bn(sd, f"v2x_mid_fusion.{block}.{bn}", fp[block][bn],
                        _sub(_sub(fs, block), bn))


def put_mlp(sd, prefix, params, stats):
    """An MLP's ``lin_{i}`` / ``norm_{i}`` -> ``{prefix}.{3i}`` (Linear) and
    ``{prefix}.{3i+1}`` (BN), as pcdet's Sequential holds them."""
    i = 0
    while f"lin_{i}" in params:
        lin, base = params[f"lin_{i}"], f"{prefix}.{3 * i}"
        sd[f"{base}.weight"] = _linear(lin["kernel"])
        if "bias" in lin:
            sd[f"{base}.bias"] = _tensor(lin["bias"])
        if f"norm_{i}" in params:
            _put_bn(sd, f"{prefix}.{3 * i + 1}", params[f"norm_{i}"], _sub(stats, f"norm_{i}"))
        i += 1
