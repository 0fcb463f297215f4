"""Collect the port's synthetic-world results into one table.

Counterpart of ``workspace/collect_results.py`` for the rows the port
produces: single-agent, late fusion (NMS, weighted box fusion, oracle flow),
mid fusion (DiscoNet, matched and crossed), early fusion, lately fusion and
the car sender:

    python -m pcp_tpu_torch.workspace.collect_results [tag] [--export] [--output_root DIR]

Reads ``metrics.json`` under ``{output_root}/cfgs/v2x_sim_models/<cfg>/
<train_tag>/eval/<eval_tag>/`` (default root ``output/torch``), or where a
cell is not there the one already exported to ``results/{tag}_torch/``, and
prints the markdown table, each cell with the JAX package's mAP of the same
cell (``results/{tag}/``) in brackets where it has one. A cell carried over
from the export is marked and its eval log named; ``matrix.json`` records
each cell's source. ``--export`` copies
each row's ``metrics.json``, its eval log and its training log into
``results/{tag}_torch/{cfg}__{train_tag}__{eval_tag}/`` and writes
``matrix.md`` and ``matrix.json`` there.
"""
import argparse
import json
import shutil
from pathlib import Path

from ..config import ROOT_DIR

EGO, CAR = "v2x_pointpillar_basic_ego", "v2x_pointpillar_basic_car"
EARLY, LATE = "v2x_pointpillar_basic_ego_early", "v2x_late_fusion"
DISCO = "v2x_pointpillar_disco"


def rows(tag):
    """(label, cfg, {column: (train_tag, eval_tag)}) of the table, in the
    JAX package's order."""
    return [("single-agent ego (no collaboration)", EGO,
             {"sync": (tag + "_nocollab", "single")}),
            ("late fusion", LATE,
             {"sync": (tag, "late_sync"), "async": (tag, "late_async"),
              "async w/o flow": (tag, "late_async_noflow")}),
            ("late fusion (weighted box fusion)", LATE,
             {"sync": (tag, "late_sync_wnms"), "async": (tag, "late_async_wnms")}),
            ("late fusion (oracle flow)", LATE, {"async": (tag, "late_async_oracleflow")}),
            ("mid fusion (DiscoNet, matched train)", DISCO,
             {"sync": (tag + "_dsync", "disco_sync"), "async": (tag, "disco_async")}),
            ("mid fusion (DiscoNet, cross: async-trained@sync / sync-trained@async)", DISCO,
             {"sync": (tag, "disco_xsync"), "async": (tag + "_dsync", "disco_xasync")}),
            ("early fusion", EARLY,
             {"sync": (tag + "_sync", "early_sync"), "async": (tag + "_async", "early_async")}),
            ("lately fusion (MoDAR, ours)", EGO,
             {"sync": (tag, "lately_sync"), "async": (tag, "lately_async"),
              "async w/o flow": (tag, "lately_async_noflow")}),
            ("per-agent car detector (own-view GT: not comparable to the rows above)", CAR,
             {"sync": (tag, "car")})]


def eval_dir(root, cfg, train_tag, eval_tag):
    return root / "cfgs" / "v2x_sim_models" / cfg / train_tag / "eval" / eval_tag


def cell_dir(tag, cfg, train_tag, eval_tag, port=True):
    """A cell's directory under ``results/``: the port's export, or the JAX
    package's."""
    return ROOT_DIR / "results" / (f"{tag}_torch" if port else tag) / f"{cfg}__{train_tag}__{eval_tag}"


def read_metrics(root, cfg, train_tag, eval_tag, tag=None):
    """The cell's metrics with a ``source`` key added: from the run under
    ``root`` ("run"), else (with ``tag``) carried over from the port's
    export ("export"), each with the name of the eval log that wrote it;
    None where neither has the cell."""
    sources = [("run", eval_dir(root, cfg, train_tag, eval_tag))]
    if tag:
        sources.append(("export", cell_dir(tag, cfg, train_tag, eval_tag)))
    for kind, path in sources:
        if (path / "metrics.json").exists():
            logs = sorted(path.glob("log_eval_*.txt"))
            source = {"from": kind, "eval_log": logs[-1].name if logs else None}
            if kind == "export":
                source["dir"] = str(path.relative_to(ROOT_DIR))
            return dict(json.loads((path / "metrics.json").read_text()), source=source)
    return None


def jax_map(tag, cfg, train_tag, eval_tag):
    path = cell_dir(tag, cfg, train_tag, eval_tag, port=False) / "metrics.json"
    return json.loads(path.read_text())["mAP"] if path.exists() else None


def table(root, tag):
    """(markdown lines, {label: {column: metrics or None}}). A cell carried
    over from the export, not produced by the run under ``root``, is marked
    with a ``*`` and the eval log that wrote it is named below the table."""
    lines = ["| collab method | sync mAP | async mAP | async w/o flow | NDS[ATE,ASE,AOE] (sync) "
             "| recall@0.3 (sync) |", "|---|---|---|---|---|---|"]
    out = {}
    for label, cfg, cols in rows(tag):
        res = {col: read_metrics(root, cfg, *spec, tag=tag) for col, spec in cols.items()}
        out[label] = res

        def fmt(col):
            m = res.get(col)
            if m is None:
                return "—"
            ref = jax_map(tag, cfg, *cols[col])
            mark = "*" if m["source"]["from"] == "export" else ""
            return f"{100 * m['mAP']:.1f}{mark}" + ("" if ref is None else f" ({100 * ref:.1f})")

        sync = res.get("sync")
        nds = "—" if sync is None else f"{100 * sync['NDS']:.1f}"
        recall = "—" if sync is None else f"{sync['recall/rcnn_0.3']:.2f}"
        lines.append(f"| {label} | {fmt('sync')} | {fmt('async')} | {fmt('async w/o flow')} | "
                     f"{nds} | {recall} |")
    carried = [(label, col, m["source"]) for label, res in out.items() for col, m in res.items()
               if m is not None and m["source"]["from"] == "export"]
    if carried:
        lines += ["", "\\* carried over from an earlier run's export, not produced by this run:"]
        lines += [f"- {label}, {col}: `{src['dir']}/{src['eval_log']}`" for label, col, src in carried]
    return lines, out


def export(root, tag, lines, results):
    out_root = ROOT_DIR / "results" / f"{tag}_torch"
    out_root.mkdir(parents=True, exist_ok=True)
    for _, cfg, cols in rows(tag):
        for train_tag, eval_tag in cols.values():
            src = eval_dir(root, cfg, train_tag, eval_tag)
            if not (src / "metrics.json").exists():
                continue
            dst = out_root / f"{cfg}__{train_tag}__{eval_tag}"
            dst.mkdir(parents=True, exist_ok=True)
            for f in [src / "metrics.json"] + sorted(src.glob("log_eval_*.txt"))[-1:]:
                shutil.copy2(f, dst / f.name)
            train_dir = src.parent.parent
            for f in sorted(train_dir.glob("log_train_*.txt"))[-1:]:
                shutil.copy2(f, dst / f.name)
    (out_root / "matrix.md").write_text("\n".join(lines) + "\n")
    (out_root / "matrix.json").write_text(json.dumps(results, indent=1))
    return out_root


def main(argv=None):
    parser = argparse.ArgumentParser(description="the port's results table")
    parser.add_argument("tag", nargs="?", default="synvf")
    parser.add_argument("--export", action="store_true")
    parser.add_argument("--output_root", default=str(ROOT_DIR / "output" / "torch"))
    args = parser.parse_args(argv)
    root = Path(args.output_root)
    lines, results = table(root, args.tag)
    print("\n".join(lines))
    if args.export:
        print(f"exported -> {export(root, args.tag, lines, results)}")
    return results


if __name__ == "__main__":
    main()
