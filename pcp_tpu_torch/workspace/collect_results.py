"""Collect the port's synthetic-world results into one table.

Counterpart of ``workspace/collect_results.py``: the rows single-agent,
late fusion (NMS, weighted box fusion, oracle flow), mid fusion (DiscoNet,
matched and crossed), early fusion, lately fusion and its variants (oracle
senders trained and swapped in at eval, broadcast dropout 0.2 and 0.5, the
loose broadcast), and the car sender; under the table the seed repeats of
the lately ego and the sync early ego, and the bandwidth of each fusion
mode:

    python -m pcp_tpu_torch.workspace.collect_results [tag] [--export] [--output_root DIR]

Reads ``metrics.json`` under ``{output_root}/cfgs/v2x_sim_models/<cfg>/
<train_tag>/eval/<eval_tag>/`` (default root ``output/torch``), or where a
cell is not there the one already exported to ``results/{tag}_torch/``, and
prints the markdown table, each cell with the JAX package's mAP of the same
cell (``results/{tag}/``) in brackets where it has one. A cell carried over
from the export is marked and its eval log named; ``matrix.json`` records
each cell's source. Each cell whose evaluation reads the senders' exchange
database (the late rows and the lately rows fed by real senders) also
names the car that fed it: the car evaluated in the same run (``eval_car``),
which the export keeps beside the cell in ``fed_by.json``. ``--export``
copies each cell's ``metrics.json``, its eval log and its training log into
``results/{tag}_torch/{cfg}__{train_tag}__{eval_tag}/`` and writes
``matrix.md`` and ``matrix.json`` there. The bandwidth is read from
``results/{tag}_torch/bandwidth.json`` (``measure_exchange_size.py``).
"""
import argparse
import json
import shutil
from pathlib import Path

from ..config import ROOT_DIR

EGO, CAR = "v2x_pointpillar_basic_ego", "v2x_pointpillar_basic_car"
EARLY, LATE = "v2x_pointpillar_basic_ego_early", "v2x_late_fusion"
DISCO = "v2x_pointpillar_disco"
LATELY = "lately fusion (MoDAR, ours)"
# the rows whose evaluation reads the exchange database the senders wrote
FED_BY_CAR = ("late fusion", "late fusion (weighted box fusion)", "late fusion (oracle flow)",
              LATELY, "lately fusion (broadcast dropout p=0.2)",
              "lately fusion (broadcast dropout p=0.5)",
              "lately fusion (loose broadcast: thresh 0.03, 200 boxes)")
SEEDS = ("s101", "s202")
BANDWIDTH_KEYS = (("early", "early_MB"), ("late", "late_MB"), ("lately", "lately_MB"),
                  ("mid (DiscoNet)", "mid_disco_MB"))


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
            (LATELY, EGO,
             {"sync": (tag, "lately_sync"), "async": (tag, "lately_async"),
              "async w/o flow": (tag, "lately_async_noflow")}),
            ("lately fusion (oracle senders)", EGO,
             {"sync": (tag + "_oracle", "lately_oracle_sync"),
              "async": (tag + "_oracle", "lately_oracle_async")}),
            ("lately fusion (oracle senders, eval-only swap)", EGO,
             {"sync": (tag, "lately_oracleswap_sync"), "async": (tag, "lately_oracleswap_async")}),
            ("lately fusion (broadcast dropout p=0.2)", EGO,
             {"sync": (tag, "lately_drop02_sync"), "async": (tag, "lately_drop02_async")}),
            ("lately fusion (broadcast dropout p=0.5)", EGO,
             {"sync": (tag, "lately_drop05_sync"), "async": (tag, "lately_drop05_async")}),
            ("lately fusion (loose broadcast: thresh 0.03, 200 boxes)", EGO,
             {"sync": (tag + "_loose", "lately_loose_sync"),
              "async": (tag + "_loose", "lately_loose_async")}),
            ("per-agent car detector (own-view GT: not comparable to the rows above)", CAR,
             {"sync": (tag, "car")})]


def seed_repeats(tag):
    """(label, cfg, column, [(seed name, train_tag, eval_tag)]) of the seed
    lines, as ``SEED_REPEATS`` of ``workspace/collect_results.py``: the
    lately ego (async, sync) and the sync early ego, seed 0 ("base") and
    the seeds of ``SEEDS``."""
    out = []
    for col in ("async", "sync"):
        out.append((LATELY, EGO, col, [("base", tag, f"lately_{col}")] + [
            (s, f"{tag}_{s}", f"lately_{col}_{s}") for s in SEEDS]))
    out.append(("early fusion", EARLY, "sync", [("base", f"{tag}_sync", "early_sync")] + [
        (s, f"{tag}_sync_{s}", f"early_sync_{s}") for s in SEEDS]))
    return out


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


def feeding_car(root, tag, cell, cfg, train_tag, eval_tag):
    """{"mAP", "eval_log"} of the car whose exchange database fed ``cell``:
    for a cell of the run under ``root``, the car that run evaluated; for
    one carried over, the car its export kept in ``fed_by.json``; None
    where neither is known."""
    if cell["source"]["from"] == "run":
        car = read_metrics(root, CAR, tag, "car")
        return None if car is None else {"mAP": car["mAP"], "eval_log": car["source"]["eval_log"]}
    path = cell_dir(tag, cfg, train_tag, eval_tag) / "fed_by.json"
    return json.loads(path.read_text()) if path.exists() else None


def read_cell(root, tag, label, cfg, train_tag, eval_tag):
    """``read_metrics`` of one cell; a cell of a row in ``FED_BY_CAR`` also
    gets the ``car`` that fed it (or None)."""
    cell = read_metrics(root, cfg, train_tag, eval_tag, tag=tag)
    if cell is not None and label in FED_BY_CAR:
        cell["car"] = feeding_car(root, tag, cell, cfg, train_tag, eval_tag)
    return cell


def fmt_map(cell, ref=None):
    """A cell's mAP, ``*`` if carried over, the JAX mAP ``ref`` in brackets
    and the car that fed it in square brackets."""
    if cell is None:
        return "—"
    text = f"{100 * cell['mAP']:.1f}" + ("*" if cell["source"]["from"] == "export" else "")
    if ref is not None:
        text += f" ({100 * ref:.1f})"
    if "car" in cell:
        text += " [car " + ("?" if cell["car"] is None else f"{100 * cell['car']['mAP']:.1f}") + "]"
    return text


def spread(values):
    """(mean, half the range) of mAPs in percent."""
    return sum(values) / len(values), (max(values) - min(values)) / 2


def seed_lines(root, tag):
    """(lines, records) of the seed repeats, as ``seed_spread_lines`` of
    ``workspace/collect_results.py``: mean ± half-range over the seeds a
    line has (two at least), each seed's mAP, and the JAX package's line."""
    lines, records = [], []
    for label, cfg, col, seeds in seed_repeats(tag):
        cells = {name: read_cell(root, tag, label, cfg, tt, et) for name, tt, et in seeds}
        cells = {name: cell for name, cell in cells.items() if cell is not None}
        if len(cells) < 2:
            continue
        mean, half = spread([100 * c["mAP"] for c in cells.values()])
        jax = [100 * m for m in (jax_map(tag, cfg, tt, et) for _, tt, et in seeds) if m is not None]
        detail = ", ".join(f"{name}={fmt_map(cell)}" for name, cell in cells.items())
        line = f"- {label} [{col}]: mAP {mean:.1f} ± {half:.1f} (n={len(cells)}: {detail})"
        record = {"label": label, "column": col, "mean": mean, "half_range": half,
                  "seeds": cells, "jax": None}
        if jax:
            jmean, jhalf = spread(jax)
            line += f"; JAX {jmean:.1f} ± {jhalf:.1f} (n={len(jax)})"
            record["jax"] = {"mean": jmean, "half_range": jhalf, "n": len(jax)}
        lines.append(line)
        records.append(record)
    return lines, records


def bandwidth(tag):
    """(lines, figures) of the bandwidth, from the port's
    ``results/{tag}_torch/bandwidth.json``, the JAX package's in brackets;
    ([], None) where the port has none."""
    path = ROOT_DIR / "results" / f"{tag}_torch" / "bandwidth.json"
    if not path.exists():
        return [], None
    port = json.loads(path.read_text())
    jax_path = ROOT_DIR / "results" / tag / "bandwidth.json"
    jax = json.loads(jax_path.read_text()) if jax_path.exists() else {}
    parts = [f"{name} {port[key]}" + (f" ({jax[key]})" if key in jax else "")
             for name, key in BANDWIDTH_KEYS]
    return ["", "Bandwidth, MB an ego sample receives (JAX in brackets): " + ", ".join(parts)], port


def table(root, tag):
    """(markdown lines, {label: {column: metrics or None}}, with the seed
    lines' records under "seed repeats" and the bandwidth under
    "bandwidth"). A cell carried over from the export, not produced by the
    run under ``root``, is marked with a ``*`` and the eval log that wrote
    it is named below the table."""
    lines = ["| collab method | sync mAP | async mAP | async w/o flow | NDS[ATE,ASE,AOE] (sync) "
             "| recall@0.3 (sync) |", "|---|---|---|---|---|---|"]
    out = {}
    for label, cfg, cols in rows(tag):
        res = {col: read_cell(root, tag, label, cfg, *spec) for col, spec in cols.items()}
        out[label] = res

        def fmt(col):
            return "—" if col not in cols else fmt_map(res[col], jax_map(tag, cfg, *cols[col]))

        sync = res.get("sync")
        nds = "—" if sync is None else f"{100 * sync['NDS']:.1f}"
        recall = "—" if sync is None else f"{sync['recall/rcnn_0.3']:.2f}"
        lines.append(f"| {label} | {fmt('sync')} | {fmt('async')} | {fmt('async w/o flow')} | "
                     f"{nds} | {recall} |")
    lines += ["", "(JAX package's mAP) in brackets; [car] the mAP of the car whose exchange "
                  "database fed the cell, evaluated in the same run."]
    spread_lines, out["seed repeats"] = seed_lines(root, tag)
    if spread_lines:
        lines += ["", "Seed repeats (mean ± half-range over independent retrains):"] + spread_lines
    bw_lines, out["bandwidth"] = bandwidth(tag)
    lines += bw_lines
    cells = [(label, col, m) for label, _, _ in rows(tag) for col, m in out[label].items()]
    cells += [(f"{r['label']} [seed {name}]", r["column"], m) for r in out["seed repeats"]
              for name, m in r["seeds"].items() if name != "base"]
    carried = [(label, col, m["source"]) for label, col, m in cells
               if m is not None and m["source"]["from"] == "export"]
    if carried:
        lines += ["", "\\* carried over from an earlier run's export, not produced by this run:"]
        lines += [f"- {label}, {col}: `{src['dir']}/{src['eval_log']}`" for label, col, src in carried]
    return lines, out


def export(root, tag, lines, results):
    """Copy each cell the run under ``root`` produced (with the car that fed
    it) into ``results/{tag}_torch/``, in place of what the cell held, and
    write the table there."""
    out_root = ROOT_DIR / "results" / f"{tag}_torch"
    out_root.mkdir(parents=True, exist_ok=True)
    cells = [(label, cfg, spec) for label, cfg, cols in rows(tag) for spec in cols.values()]
    cells += [(label, cfg, (tt, et)) for label, cfg, _, seeds in seed_repeats(tag)
              for _, tt, et in seeds]
    for label, cfg, (train_tag, eval_tag) in cells:
        src = eval_dir(root, cfg, train_tag, eval_tag)
        if not (src / "metrics.json").exists():
            continue
        dst = out_root / f"{cfg}__{train_tag}__{eval_tag}"
        shutil.rmtree(dst, ignore_errors=True)  # the cell is this run's alone
        dst.mkdir(parents=True)
        for f in [src / "metrics.json"] + sorted(src.glob("log_eval_*.txt"))[-1:]:
            shutil.copy2(f, dst / f.name)
        train_dir = src.parent.parent
        for f in sorted(train_dir.glob("log_train_*.txt"))[-1:]:
            shutil.copy2(f, dst / f.name)
        cell = read_cell(root, tag, label, cfg, train_tag, eval_tag)
        if cell.get("car") is not None:
            (dst / "fed_by.json").write_text(json.dumps(cell["car"], indent=1))
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
