"""Probes of the car sender's synvf row (ROADMAP C1): the port's trained
weights carried into the JAX package, on the CPU. It imports jax, so it
lives beside the tests; it is not a test and the port never imports it.
Both subcommands run at full width on the synvf recipe's data.

    JAX_PLATFORMS=cpu python tests/torch_c1_probe.py orbax <model.pt> <out dir>

writes an orbax checkpoint ({"params", "batch_stats"}) of a state dict of
the port's car (``tools_torch/export_run.py`` writes one from a training
run; bfloat16 entries are cast to float32), converted by
``pcp_tpu/utils/torch_converter.py::convert_centerpoint_state_dict``, which
the JAX package's ``tools/test.py --ckpt`` evaluates:

    JAX_PLATFORMS=cpu python tools/test.py --cfg_file tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml \
        --ckpt <out dir> --batch_size 4 --extra_tag c1_probe --eval_tag car \
        --set <the synvf recipe's DATA_CONFIG pairs> DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO 1

    JAX_PLATFORMS=cpu python tests/torch_c1_probe.py step <model.pt> --epoch 17 --its 6 18 \
        [--optim optim.pt] [--f64] [--batch_size 4] [--out step.json]

takes one training step from those weights on batch ``it`` of epoch
``epoch`` of the synvf car recipe (seed 0: the port's loader draws each item
from a generator of (seed, epoch, index), so the batch replays), in both
packages: the JAX package's jitted ``make_train_step`` (and its jitted
``value_and_grad`` for the gradients, as that step takes them) against the
port's ``take_train_step`` at 8 and at 4 torch threads. The optimizer
starts from the moments and count of ``--optim`` (written by
``tools_torch/export_run.py --bf16_optim``), else from zero moments at the
count that batch had. Prints and writes each loss term, the global gradient
norm before the clip, the leaves whose gradients differ most (against their
largest |g|) and every parameter leaf after the step against max(1e-5, 3x
the port's own spread between the two thread counts). ``--f64`` also takes
the port's gradient in float64 and reports, for each leaf, how far the JAX
package's float32 gradient and the port's lie from it.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
CFG_CAR = REPO / "tools/cfgs/v2x_sim_models/v2x_pointpillar_basic_car.yaml"
# the synvf recipe of pcp_tpu_torch/workspace/synth_experiments.sh for the car
SYNVF = ["DATA_CONFIG.USE_SYNTHETIC_DATA", "True", "DATA_CONFIG.MAX_POINTS_PER_SAMPLE", "32768",
         "DATA_CONFIG.SYNTHETIC",
         "{'NUM_SCENES': 15, 'KEYFRAMES_PER_SCENE': 12, 'NUM_CARS': 24, 'NUM_PEDS': 8, "
         "'WORLD': 'urban', 'NUM_PARKED': 16, 'VISIBLE_FACES': True}",
         "DATA_CONFIG.MINI_TRAINVAL_STRIDE", "1", "OPTIMIZATION.LR", "0.003",
         "DATA_CONFIG.DATASET_DOWNSAMPLING_RATIO", "4"]
EPOCHS, SEED = 25, 0
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def jax_variables(state_dict_path, cfg_path=CFG_CAR):
    """The JAX package's variables of the port's state dict at ``state_dict_path``."""
    from pcp_tpu.config import CfgDict, cfg_from_yaml_file
    from pcp_tpu.utils.torch_converter import convert_centerpoint_state_dict

    sd = {k: v.numpy() for k, v in load_state_dict(state_dict_path).items()}
    cfg = cfg_from_yaml_file(str(cfg_path), CfgDict())
    return convert_centerpoint_state_dict(sd, cfg.MODEL)


def write_orbax(state_dict_path, out_dir):
    import orbax.checkpoint as ocp

    variables = jax_variables(state_dict_path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(Path(out_dir).absolute(), {"params": variables["params"],
                                          "batch_stats": variables["batch_stats"]}, force=True)
    ckptr.wait_until_finished()
    n = sum(np.asarray(x).size for x in __import__("jax").tree_util.tree_leaves(variables))
    print(f"{out_dir}: {n} values")


def load_state_dict(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}


def _cfgs():
    from pcp_tpu.config import CfgDict as JaxCfg
    from pcp_tpu.config import cfg_from_list as jax_cfg_from_list
    from pcp_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
    from pcp_tpu_torch.config import CfgDict, cfg_from_list, cfg_from_yaml_file

    jcfg = jax_cfg_from_yaml(str(CFG_CAR), JaxCfg())
    jax_cfg_from_list(list(SYNVF), jcfg)
    tcfg = cfg_from_yaml_file(CFG_CAR, CfgDict())
    cfg_from_list(list(SYNVF), tcfg)
    return jcfg, tcfg


def replay_batch(tcfg, epoch, it, batch_size):
    """Batch ``it`` of epoch ``epoch`` as the port's trainer saw it (seed 0),
    as numpy arrays; and the number of batches an epoch."""
    from pcp_tpu_torch.datasets import build_dataloader
    from pcp_tpu_torch.datasets.loader import item_rng

    ds, loader, _ = build_dataloader(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, batch_size=batch_size,
                                     workers=0, seed=SEED, training=True)
    order = torch.randperm(len(ds), generator=torch.Generator().manual_seed(SEED + epoch)).tolist()
    keys = order[it * batch_size:(it + 1) * batch_size]
    batch = ds.collate_batch([ds.get_item(i, item_rng(SEED, epoch, i)) for i in keys])
    keep = ("points", "points_mask", "gt_boxes", "instances_tf")
    return {k: np.asarray(batch[k]) for k in keep}, len(loader)


def with_fields(opt_state, **fields):
    """``opt_state`` (an optax state: nested tuples and named tuples) with
    each named tuple that has some of ``fields`` given those values, e.g.
    ``count`` or the Adam moments ``mu`` and ``nu``."""
    if hasattr(opt_state, "_fields"):
        own = {k: v for k, v in fields.items() if k in opt_state._fields}
        if own:
            return opt_state._replace(**own)
        return type(opt_state)(*(with_fields(x, **fields) for x in opt_state))
    if isinstance(opt_state, tuple):
        return tuple(with_fields(x, **fields) for x in opt_state)
    return opt_state


def jax_moments(moments, sd, model_cfg):
    """Moments named as the port's parameters -> trees shaped like the JAX
    params (kernels transposed and flipped as the weights are)."""
    from pcp_tpu.utils.torch_converter import convert_centerpoint_state_dict

    out = []
    for key in ("mu", "nu"):
        fake = {k: v.numpy() for k, v in sd.items()}
        fake.update({k: v.float().numpy() for k, v in moments[key].items()})
        out.append(convert_centerpoint_state_dict(fake, model_cfg)["params"])
    return out


def jax_step(jcfg, variables, batch, step, iters_per_epoch, moments=None):
    """(loss, tb, gradients, params and stats after) of the JAX package's
    jitted train step."""
    import jax
    import jax.numpy as jnp

    from pcp_tpu.models import build_network
    from pcp_tpu.models.detectors.detector_template import DatasetInfo
    from pcp_tpu.train import build_optimizer
    from pcp_tpu.train.train_state import TrainState, make_train_step

    info = DatasetInfo.from_data_cfg(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES)
    model = build_network(jcfg.MODEL, num_class=1, dataset_info=info)
    tx, _ = build_optimizer(jcfg.OPTIMIZATION, iters_per_epoch, EPOCHS)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["batch_size"] = batch["points"].shape[0]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), 0x5A3D)
    opt_state = with_fields(tx.init(params), count=jnp.asarray(step, jnp.int32))
    if moments is not None:
        mu, nu = (jax.tree_util.tree_map(jnp.asarray, m) for m in moments)
        opt_state = with_fields(opt_state, mu=mu, nu=nu)
    state = TrainState(params=params, batch_stats=stats, opt_state=opt_state, step=step, rng=rng)

    def loss_fn(p, bs, b):  # make_train_step's, with its rngs
        key = jax.random.fold_in(rng, step)
        out, _ = model.apply({"params": p, "batch_stats": bs}, b, train=True,
                             mutable=["batch_stats"],
                             rngs={"sampling": key, "dropout": jax.random.fold_in(key, 1)})
        return out["loss"], out["tb_dict"]

    # the batch is an argument, not a constant: it stays out of XLA's folding
    (loss, tb), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, stats, jb)
    new_state, loss2, _ = make_train_step(model, tx, donate=False)(state, jb)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (float(loss), {k: float(v) for k, v in tb.items()}, to_np(grads),
            {"params": to_np(new_state.params), "batch_stats": to_np(new_state.batch_stats)},
            float(loss2))


def torch_step(tcfg, sd, batch, step, iters_per_epoch, threads, moments=None,
               dtype=torch.float32):
    """(loss, tb, gradients before the clip, the norm, state after) of the
    port's train step at ``threads`` torch threads, in ``dtype``."""
    from pcp_tpu_torch.models import DatasetInfo, build_network
    from pcp_tpu_torch.train.optimization import build_optimizer
    from pcp_tpu_torch.train.train_state import create_train_state, take_train_step

    torch.set_num_threads(threads)
    model = build_network(tcfg.MODEL, 1, DatasetInfo.from_data_cfg(tcfg.DATA_CONFIG, ["car"]),
                          device="cpu")
    optimizer, _ = build_optimizer(tcfg.OPTIMIZATION, model, iters_per_epoch, EPOCHS)
    state = create_train_state(model, optimizer, SEED)
    model.load_state_dict(sd, strict=True)
    model.to(dtype)
    optimizer.param_groups[0]["count"] = step
    if moments is not None:
        for name, param in model.named_parameters():
            optimizer.state[param] = {key: moments[key][name].to(dtype) for key in ("mu", "nu")}
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in model.named_parameters()]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb = {k: v.to(dtype) if v.is_floating_point() else v for k, v in tb.items()}
    out = take_train_step(model, optimizer, tb)
    for h in hooks:
        h.remove()
    return (out["loss"].item(), {k: v.item() for k, v in out["tb_dict"].items()}, grads,
            float(optimizer.grad_norm), {k: v.clone() for k, v in state.model.state_dict().items()})


def step_probe(state_dict_path, epoch, its, batch_size, out_path, optim_path=None, f64=False):
    import jax

    from pcp_tpu_torch.train.train_state import biases_before_bn
    from pcp_tpu_torch.utils.jax_weights import state_dict_from_jax_variables, tensors_from_jax_params

    jcfg, tcfg = _cfgs()
    sd = load_state_dict(state_dict_path)
    variables = jax_variables(state_dict_path)
    moments = None
    if optim_path is not None:
        moments = torch.load(optim_path, map_location="cpu", weights_only=True)
        jmoments = jax_moments(moments, sd, jcfg.MODEL)
    report = []
    for it in its:
        batch, per_epoch = replay_batch(tcfg, epoch, it, batch_size)
        step = epoch * per_epoch + it
        if moments is not None:
            if it != 0 or moments["count"] != step:
                raise ValueError(f"--optim holds the state at step {moments['count']}: "
                                 f"give --its 0 of that epoch (step {step})")
        jloss, jtb, jgrads, jafter, jloss2 = jax_step(jcfg, variables, batch, step, per_epoch,
                                                      jmoments if moments is not None else None)
        jnorm = float(np.sqrt(sum(float(np.sum(np.square(g)))
                                  for g in jax.tree_util.tree_leaves(jgrads))))
        jgrads = tensors_from_jax_params(jgrads, tcfg.MODEL)
        jafter = state_dict_from_jax_variables(jafter, tcfg.MODEL)
        runs = {t: torch_step(tcfg, sd, batch, step, per_epoch, t, moments) for t in (8, 4)}
        tloss, ttb, tgrads, tnorm, tafter = runs[8]
        rec = {"epoch": epoch, "it": it, "step": step, "loss": [jloss, tloss, runs[4][0]],
               "loss_make_train_step": jloss2, "grad_norm": [jnorm, tnorm, runs[4][3]],
               "tb": {k: [jtb[k], ttb[k], runs[4][1][k]] for k in jtb}}
        leaf = []
        for n, g in tgrads.items():
            w, h = jgrads[n], runs[4][2][n]
            top = max(w.abs().max().item(), 1e-30)
            leaf.append((n, (g - w).abs().max().item() / top, (g - h).abs().max().item() / top,
                         w.norm().item(), g.norm().item()))
        leaf.sort(key=lambda x: -x[1])
        rec["grad_leaves_worst"] = leaf[:12]
        if f64:
            g64 = torch_step(tcfg, sd, batch, step, per_epoch, 8, moments, torch.float64)[2]
            from pcp_tpu_torch.models import DatasetInfo, build_network

            probe_model = build_network(tcfg.MODEL, 1, DatasetInfo.from_data_cfg(
                tcfg.DATA_CONFIG, ["car"]), device="cpu")
            # leaves whose gradient is 0 in exact arithmetic (the conv biases in
            # front of a BN, the shape encoder's last BN bias: test_torch_sender_train.py)
            enc = probe_model.corrector.object_head.points_shape_encoder
            exact_zero = biases_before_bn(probe_model) | {
                f"corrector.object_head.points_shape_encoder.{len(enc) - 2}.bias"}
            rows = []
            for n, w64 in g64.items():
                top = w64.abs().max().item()
                if n in exact_zero or top == 0.0:
                    continue
                rows.append((n, (jgrads[n].double() - w64).abs().max().item() / top,
                             (tgrads[n].double() - w64).abs().max().item() / top))
            rows.sort(key=lambda x: -x[1] / max(x[2], 1e-30))
            rec["f64_leaves"] = {"worst_ratio": rows[:12],
                                 "max_jax_err": max(r[1] for r in rows),
                                 "max_port_err": max(r[2] for r in rows)}
        params = []
        for n, p in tafter.items():
            if not p.is_floating_point():
                continue
            spread = (p - runs[4][4][n]).abs().max().item()
            limit = max(1e-5, 3 * spread)
            err = (p - jafter[n]).abs().max().item()
            params.append((n, err, limit, err <= limit))
        rec["params_out_of_tolerance"] = [x for x in params if not x[3]]
        rec["params_checked"] = len(params)
        report.append(rec)
        print(json.dumps(rec, indent=1), flush=True)
    if out_path:
        Path(out_path).write_text(json.dumps(report, indent=1))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("orbax", help="a state dict of the port's car as an orbax checkpoint")
    p.add_argument("state_dict")
    p.add_argument("out_dir")
    p = sub.add_parser("step", help="one training step in both packages from the same weights")
    p.add_argument("state_dict")
    p.add_argument("--epoch", type=int, default=17)
    p.add_argument("--its", type=int, nargs="+", default=[6])
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--out", default=None)
    p.add_argument("--optim", default=None)
    p.add_argument("--f64", action="store_true")
    args = parser.parse_args(argv)
    if args.cmd == "orbax":
        write_orbax(args.state_dict, args.out_dir)
    else:
        step_probe(args.state_dict, args.epoch, args.its, args.batch_size, args.out,
                   args.optim, args.f64)


if __name__ == "__main__":
    main()
