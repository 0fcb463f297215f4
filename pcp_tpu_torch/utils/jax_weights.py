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
  * AnchorHeadSingle's Dense ``conv_cls`` / ``conv_box`` / ``conv_dir_cls``
    kernel (in, out) -> the 1x1 Conv2d weight (out, in, 1, 1)
  * an SCConv backbone's ``{conv, norm}`` pairs -> SCNet's names
    (``backbone_2d.stem.3.scconv.k2.1.weight``, ...;
    ``models/backbones_2d/sc_conv_backbone.py``)
  * a sparse conv kernel (K * Cin, Cout), K in ``kernel_offsets`` order
    (z, y, x) -> spconv 2.x's (Cout, kz, ky, kx, Cin) under pcdet's names of
    the SECOND backbone (``backbone_3d.conv_input.0.weight``,
    ``backbone_3d.conv1.0.conv1.weight``, ``backbone_3d.conv2.0.0.weight``, ...;
    ``models/backbones_3d/spconv_backbone.py``)
  * PointRCNN: a shared MLP's ``dense_{j}`` / ``bn_{j}`` -> ``{3j}`` /
    ``{3j+1}`` (``{2j}`` without BN) under ``backbone_3d.SA_modules.{k}.mlps.{i}``,
    ``backbone_3d.FP_modules.{i}.mlp``, ``roi_head.xyz_up_layer``,
    ``roi_head.merge_down_layer`` and ``roi_head.SA_modules.{k}.mlps.0``; the
    point head's ``cls_{i}`` / ``cls_bn_{i}`` / ``cls_out`` (and ``box_*``)
    -> ``point_head.cls_layers`` (``box_layers``) at 3i, 3i+1 and last; the
    ROI head's ``cls_fc_*`` / ``cls_out`` (``reg_fc_*`` / ``reg_out``) ->
    ``roi_head.cls_layers`` (``reg_layers``), whose Dropout after the first
    width shifts the later indices by one
  * PV-RCNN: the VSA's ``sa_rawpoints`` and ``sa_{level}`` -> ``pfe.SA_rawpoints``
    and ``pfe.SA_layers.{k}`` (the levels in ``FEATURES_SOURCE`` order),
    ``fusion`` / ``fusion_bn`` -> ``pfe.vsa_point_feature_fusion.{0,1}``;
    PointHeadSimple's ``cls_*`` -> ``point_head.cls_layers``; the ROI head's
    ``roi_grid_pool`` -> ``roi_head.roi_grid_pool_layer``,
    ``shared_fc_{i}_0`` / ``shared_fc_{i}_bn_0`` -> ``roi_head.shared_fc_layer``
    (a Dropout after the first width when DP_RATIO > 0), ``cls_fc_*`` and
    ``reg_fc_*`` as PointRCNN's. The JAX package flattens the pooled grid
    grid-major (G^3 x C) into its first shared layer, pcdet channel-major (C
    x G^3): that layer's input columns are permuted
    (:func:`grid_major_to_channel_major`)
  * PV-RCNN++: a VectorPool source of the VSA or ROI grid pool
    (:func:`_vector_pool`): ``group_{k}`` -> ``layer_{k}`` (``reduce``,
    ``grouped_kernel`` -> ``separate_local_aggregation_layer``,
    ``grouped_bn`` -> ``separate_local_aggregation_bn``, ``post_{i}`` /
    ``post_bn_{i}`` -> ``post_mlps``), ``msg_post_{i}`` / ``msg_post_bn_{i}``
    -> ``msg_post_mlps``
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
    """Map flax ``variables`` of a model built from ``model_cfg`` (the MODEL
    config) to a pcdet-named state dict of tensors. Sub-modules whose key
    (BEV_MAKER_*, TEACHER, VFE, BACKBONE_3D, BACKBONE_2D, CORRECTOR,
    V2X_MID_FUSION, DENSE_HEAD, POINT_HEAD, ROI_HEAD) the config lacks, or whose subtree the
    variables lack (an eval-mode init never calls the early maker or the
    teacher), are skipped."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd = {}
    for key in ("BEV_MAKER_RSU", "BEV_MAKER_CAR", "BEV_MAKER_EARLY", "TEACHER"):
        name = key.lower()
        if model_cfg.get(key) is not None and name in params:
            _single_agent(sd, params[name], _sub(stats, name), model_cfg[key], f"{name}.")
    _single_agent(sd, params, stats, model_cfg)
    if model_cfg.get("BACKBONE_3D") is not None:
        put_b3d = _pointnet2 if model_cfg["BACKBONE_3D"]["NAME"] == "PointNet2MSG" else _backbone_3d
        put_b3d(sd, params["backbone_3d"], _sub(stats, "backbone_3d"))
    if model_cfg.get("PFE") is not None:
        _pfe(sd, params["pfe"], _sub(stats, "pfe"), model_cfg["PFE"])
    if model_cfg.get("POINT_HEAD") is not None:
        _point_head(sd, params["point_head"], _sub(stats, "point_head"))
    if model_cfg.get("ROI_HEAD") is not None:
        put_roi = _pvrcnn_head if model_cfg["ROI_HEAD"]["NAME"] == "PVRCNNHead" else _pointrcnn_head
        put_roi(sd, params["roi_head"], _sub(stats, "roi_head"), model_cfg["ROI_HEAD"])
    if "CORRECTOR" in model_cfg and model_cfg["CORRECTOR"]["NAME"] == "HunterJr":
        _corrector(sd, params["corrector"], _sub(stats, "corrector"))
    if model_cfg.get("V2X_MID_FUSION") is not None and "v2x_mid_fusion" in params:
        _disco(sd, params["v2x_mid_fusion"], _sub(stats, "v2x_mid_fusion"))
    if "DENSE_HEAD" in model_cfg:
        put_head = _anchor_head if model_cfg["DENSE_HEAD"]["NAME"] == "AnchorHeadSingle" else _head
        put_head(sd, params["dense_head"], _sub(stats, "dense_head"), model_cfg["DENSE_HEAD"])
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
    if "VFE" in cfg and "vfe" in params:  # a mean VFE has no parameters
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
    if bcfg["NAME"].startswith("SCConvBackbone2d"):
        return _sc_backbone(sd, bb_p, bb_s, f"{prefix}backbone_2d")
    _base_backbone(sd, bb_p, bb_s, bcfg, prefix)


def _base_backbone(sd, bb_p, bb_s, bcfg, prefix=""):
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


def _sc_backbone(sd, bp, bs, base):
    """An SCConv backbone: the JAX package's ``{conv, norm}`` pairs under
    the names of ``models/backbones_2d/sc_conv_backbone.py``."""
    def conv_bn(jax_name, conv, bn, p=bp, s=bs):
        _put_conv(sd, conv, p[jax_name]["conv"])
        _put_bn(sd, bn, p[jax_name]["norm"], _sub(_sub(s, jax_name), "norm"))

    def bottleneck(jax_name, key):
        p, s = bp[jax_name], _sub(bs, jax_name)
        for branch in ("a", "b"):
            conv_bn(f"conv1_{branch}", f"{key}.conv1_{branch}", f"{key}.bn1_{branch}", p, s)
        conv_bn("k1", f"{key}.k1.0", f"{key}.k1.1", p, s)
        conv_bn("conv3", f"{key}.conv3", f"{key}.bn3", p, s)
        sp, ss = p["scconv"], _sub(s, "scconv")
        conv_bn("k2", f"{key}.scconv.k2.1", f"{key}.scconv.k2.2", sp, ss)
        for k in ("k3", "k4"):
            conv_bn(k, f"{key}.scconv.{k}.0", f"{key}.scconv.{k}.1", sp, ss)

    for jax_name, key in (("stem_conv", "stem"), ("conv_skip", "conv_skip"),
                          ("main_down", "main"), ("conv_out", "conv_out")):
        conv_bn(jax_name, f"{base}.{key}.0", f"{base}.{key}.1")
    for i in range(3):
        bottleneck(f"stem_sc{i}", f"{base}.stem.{3 + i}")
        bottleneck(f"main_sc{i}", f"{base}.main.{3 + i}")
    _put_conv(sd, f"{base}.main.6", bp["main_up"]["deconv"], _deconv)
    _put_bn(sd, f"{base}.main.7", bp["main_up"]["norm"], _sub(_sub(bs, "main_up"), "norm"))


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


def _anchor_head(sd, hd_p, hd_s, hcfg):  # the head has no BN; the signature is _head's
    for name in ("conv_cls", "conv_box", "conv_dir_cls"):
        if name in hd_p:
            k = np.asarray(hd_p[name]["kernel"])
            sd[f"dense_head.{name}.weight"] = _tensor(k.T[:, :, None, None])
            sd[f"dense_head.{name}.bias"] = _tensor(hd_p[name]["bias"])


def _sparse_kernel(k, kernel_size):
    """A JAX sparse conv kernel (K * Cin, Cout) -> (Cout, kz, ky, kx, Cin)."""
    k = np.asarray(k)
    cout = k.shape[1]
    return _tensor(k.reshape(*kernel_size, -1, cout).transpose(4, 0, 1, 2, 3))


def _backbone_3d(sd, bp, bs):
    def block(jax_name, key):
        p, s = bp[jax_name], _sub(bs, jax_name)
        for i in (1, 2):
            conv = p[f"conv{i}"]
            sd[f"backbone_3d.{key}.conv{i}.weight"] = _sparse_kernel(conv["kernel"], (3, 3, 3))
            _put_bn(sd, f"backbone_3d.{key}.bn{i}", conv["norm"], _sub(_sub(s, f"conv{i}"), "norm"))

    def single(jax_name, key, ksize=(3, 3, 3)):
        p, s = bp[jax_name], _sub(bs, jax_name)
        sd[f"backbone_3d.{key}.0.weight"] = _sparse_kernel(p["kernel"], ksize)
        _put_bn(sd, f"backbone_3d.{key}.1", p["norm"], _sub(s, "norm"))

    single("conv_input", "conv_input")
    i = 0
    while f"conv1_{i}" in bp:
        block(f"conv1_{i}", f"conv1.{i}")
        i += 1
    for name in ("conv2", "conv3", "conv4"):  # JAX's {name}_down, {name}_{i}
        single(f"{name}_down", f"{name}.0")
        i = 0
        while f"{name}_{i}" in bp:
            block(f"{name}_{i}", f"{name}.{i + 1}")
            i += 1
    single("conv_out", "conv_out", (3, 1, 1))


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


def _put_linear(sd, prefix, params):
    sd[f"{prefix}.weight"] = _linear(params["kernel"])
    if "bias" in params:
        sd[f"{prefix}.bias"] = _tensor(params["bias"])


def _shared_mlp(sd, prefix, params, stats):
    """``dense_{j}`` (and ``bn_{j}``) -> ``{prefix}.{3j}`` and ``.{3j+1}``,
    or without BN ``{prefix}.{2j}``."""
    use_bn = "bn_0" in params
    j = 0
    while f"dense_{j}" in params:
        _put_linear(sd, f"{prefix}.{3 * j if use_bn else 2 * j}", params[f"dense_{j}"])
        if use_bn:
            _put_bn(sd, f"{prefix}.{3 * j + 1}", params[f"bn_{j}"], _sub(stats, f"bn_{j}"))
        j += 1


def _fc_tower(sd, prefix, params, stats, name, out_name, dropout_after_first=False):
    """``{name}_{i}`` / ``{name}_bn_{i}`` then ``{out_name}`` -> a Sequential
    of [Linear, BN, ReLU] per width (a Dropout after the first when
    ``dropout_after_first``) and a last Linear."""
    pos, i = 0, 0
    while f"{name}_{i}" in params:
        _put_linear(sd, f"{prefix}.{pos}", params[f"{name}_{i}"])
        _put_bn(sd, f"{prefix}.{pos + 1}", params[f"{name}_bn_{i}"], _sub(stats, f"{name}_bn_{i}"))
        pos += 4 if (dropout_after_first and i == 0) else 3
        i += 1
    _put_linear(sd, f"{prefix}.{pos}", params[out_name])


def _pointnet2(sd, bp, bs):
    k = 0
    while f"sa_{k}" in bp:
        _sa_msg(sd, f"backbone_3d.SA_modules.{k}", bp[f"sa_{k}"], _sub(bs, f"sa_{k}"))
        k += 1
    i = 0
    while f"fp_{i}" in bp:
        _shared_mlp(sd, f"backbone_3d.FP_modules.{i}.mlp", bp[f"fp_{i}"]["mlp"],
                    _sub(_sub(bs, f"fp_{i}"), "mlp"))
        i += 1


def _point_head(sd, hp, hs):
    _fc_tower(sd, "point_head.cls_layers", hp, hs, "cls", "cls_out")
    if "box_out" in hp:  # PointHeadBox; PointHeadSimple has the class tower alone
        _fc_tower(sd, "point_head.box_layers", hp, hs, "box", "box_out")


def _sa_msg(sd, prefix, sp, ss):
    """A set abstraction's ``mlp_{i}`` -> ``{prefix}.mlps.{i}``."""
    i = 0
    while f"mlp_{i}" in sp:
        _shared_mlp(sd, f"{prefix}.mlps.{i}", sp[f"mlp_{i}"], _sub(ss, f"mlp_{i}"))
        i += 1


def _vector_pool(sd, prefix, vp, vs):
    """A VectorPoolAggregationModuleMSG's ``group_{k}`` -> ``{prefix}.layer_{k}``
    (``reduce``, the grouped kernel (V, C_in, C_out) as pcdet's grouped 1x1
    weight (V * C_out, C_in, 1), its BN, ``post_mlps``) and ``msg_post_{i}``
    -> ``{prefix}.msg_post_mlps``."""
    def mlp(dst, src, src_bn, p, s):
        i = 0
        while f"{src}_{i}" in p:
            _put_linear(sd, f"{dst}.{3 * i}", p[f"{src}_{i}"])
            _put_bn(sd, f"{dst}.{3 * i + 1}", p[f"{src_bn}_{i}"], _sub(s, f"{src_bn}_{i}"))
            i += 1

    k = 0
    while f"group_{k}" in vp:
        gp, gs, base = vp[f"group_{k}"], _sub(vs, f"group_{k}"), f"{prefix}.layer_{k}"
        if "reduce" in gp:
            _put_linear(sd, f"{base}.reduce", gp["reduce"])
        kernel = np.asarray(gp["grouped_kernel"])
        sd[f"{base}.separate_local_aggregation_layer.weight"] = _tensor(
            kernel.transpose(0, 2, 1).reshape(-1, kernel.shape[1], 1))
        _put_bn(sd, f"{base}.separate_local_aggregation_bn", gp["grouped_bn"],
                _sub(gs, "grouped_bn"))
        mlp(f"{base}.post_mlps", "post", "post_bn", gp, gs)
        k += 1
    mlp(f"{prefix}.msg_post_mlps", "msg_post", "msg_post_bn", vp, vs)


def _aggregation(sd, prefix, src_cfg, params, stats):
    put = _vector_pool if src_cfg.get("NAME") == "VectorPoolAggregationModuleMSG" else _sa_msg
    put(sd, prefix, params, stats)


def _pfe(sd, fp, fs, pcfg):
    sources, sa_cfg = list(pcfg["FEATURES_SOURCE"]), pcfg["SA_LAYER"]
    if "raw_points" in sources:
        _aggregation(sd, "pfe.SA_rawpoints", sa_cfg["raw_points"], fp["sa_rawpoints"],
                     _sub(fs, "sa_rawpoints"))
    levels = [src for src in sources if src not in ("bev", "raw_points")]
    for k, src in enumerate(levels):
        _aggregation(sd, f"pfe.SA_layers.{k}", sa_cfg[src], fp[f"sa_{src}"], _sub(fs, f"sa_{src}"))
    _put_linear(sd, "pfe.vsa_point_feature_fusion.0", fp["fusion"])
    _put_bn(sd, "pfe.vsa_point_feature_fusion.1", fp["fusion_bn"], _sub(fs, "fusion_bn"))


def grid_major_to_channel_major(kernel, grid_points):
    """A Dense kernel (G^3 * C, out) whose rows run grid point outer ->
    the same kernel with its rows channel outer (C * G^3, out)."""
    k = np.asarray(kernel)
    rows, width = k.shape
    c = rows // grid_points
    return k.reshape(grid_points, c, width).transpose(1, 0, 2).reshape(rows, width)


def _pvrcnn_head(sd, rp, rs, rcfg):
    _aggregation(sd, "roi_head.roi_grid_pool_layer", rcfg["ROI_GRID_POOL"], rp["roi_grid_pool"],
                 _sub(rs, "roi_grid_pool"))
    grid_points = int(rcfg["ROI_GRID_POOL"]["GRID_SIZE"]) ** 3
    dropout = float(rcfg.get("DP_RATIO", 0.0))
    pos = 0
    for i in range(len(rcfg["SHARED_FC"])):
        dense = dict(rp[f"shared_fc_{i}_0"])
        if i == 0:
            dense["kernel"] = grid_major_to_channel_major(dense["kernel"], grid_points)
        _put_linear(sd, f"roi_head.shared_fc_layer.{pos}", dense)
        _put_bn(sd, f"roi_head.shared_fc_layer.{pos + 1}", rp[f"shared_fc_{i}_bn_0"],
                _sub(rs, f"shared_fc_{i}_bn_0"))
        pos += 4 if (dropout > 0 and i == 0) else 3
    _fc_tower(sd, "roi_head.cls_layers", rp, rs, "cls_fc", "cls_out", dropout >= 0)
    _fc_tower(sd, "roi_head.reg_layers", rp, rs, "reg_fc", "reg_out", dropout >= 0)


def _pointrcnn_head(sd, rp, rs, rcfg):
    _shared_mlp(sd, "roi_head.xyz_up_layer", rp["xyz_up"], _sub(rs, "xyz_up"))
    _shared_mlp(sd, "roi_head.merge_down_layer", rp["merge_down"], _sub(rs, "merge_down"))
    k = 0
    while f"sa_{k}" in rp:
        _sa_msg(sd, f"roi_head.SA_modules.{k}", rp[f"sa_{k}"], _sub(rs, f"sa_{k}"))
        k += 1
    dropout = float(rcfg.get("DP_RATIO", 0.0)) >= 0
    _fc_tower(sd, "roi_head.cls_layers", rp, rs, "cls_fc", "cls_out", dropout)
    _fc_tower(sd, "roi_head.reg_layers", rp, rs, "reg_fc", "reg_out", dropout)
