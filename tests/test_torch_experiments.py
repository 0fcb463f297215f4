"""The port's experiment layer against the JAX package's.

* the bandwidth tool: ``measure_early``, ``measure_lately`` and
  ``measure_mid`` of the port equal the JAX package's on a tiny synthetic
  world, with an exchange database the port's ``exchange/database.py``
  wrote (boxflow, and the legacy boxes and foreground points);
* the results table: the rows and seed repeats of
  ``workspace/collect_results.py`` under its labels and tags; on a results
  tree made here, the car beside each cell the senders fed, the seed lines
  with the JAX package's line, the bandwidth, and the export of the car;
* the pipeline: every train, exchange, eval and bandwidth stage of
  ``workspace/synth_experiments.sh`` (``export_bench_ckpt`` aside) is a
  stage of ``pcp_tpu_torch/workspace/synth_experiments.sh``, in the same
  order.
"""
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pcp_tpu_torch.datasets.v2x_sim.source import SyntheticV2XSource
from pcp_tpu_torch.exchange.database import ExchangeDatabase, pool_box_flow
from pcp_tpu_torch.workspace import collect_results
from pcp_tpu_torch.workspace import measure_exchange_size as port_measure

REPO = Path(__file__).resolve().parent.parent
SYN = {"NUM_SCENES": 3, "KEYFRAMES_PER_SCENE": 3, "NUM_CARS": 8, "NUM_PEDS": 2, "WORLD": "urban",
       "NUM_PARKED": 4, "VISIBLE_FACES": True}


def _load(path, name, argv=None, monkeypatch=None):
    """A module of the JAX package's ``workspace/`` (not a package), with
    ``sys.argv`` set to ``argv`` while it is imported."""
    if argv is not None:
        monkeypatch.setattr(sys, "argv", argv)
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def exchange_dbs(tmp_path_factory):
    """Two exchange databases the port's writer wrote from the same seeded
    arrays (each sender's gt jittered, a score, label 1, foreground points
    with flow in the boxes): ``boxflow`` holds the pooled boxes, ``legacy``
    the boxes and the foreground points."""
    root = tmp_path_factory.mktemp("bandwidth")
    rng = np.random.default_rng(5)
    src = SyntheticV2XSource(num_scenes=3, keyframes_per_scene=3, num_cars=8, num_peds=2,
                             world="urban", num_parked=4, visible_faces=True)
    boxflow, legacy = ExchangeDatabase(root / "boxflow"), ExchangeDatabase(root / "legacy")
    for scene, kf in src.iter_samples():
        token = src.sample_token(scene, kf)
        for lid in (0, 2, 3, 4, 5):
            boxes = src.get_frame(src.lidar_token(scene, kf, lid), classes_of_interest=("car",))["boxes"]
            if boxes.shape[0] == 0:
                continue
            modar = np.zeros((boxes.shape[0], 9), np.float32)
            modar[:, :7] = boxes + rng.normal(0, 0.1, boxes.shape)
            modar[:, 7] = rng.uniform(0.3, 1.0, boxes.shape[0])
            modar[:, 8] = 1.0
            fg = np.zeros((3 * boxes.shape[0], 13), np.float32)
            fg[:, :3] = np.repeat(boxes[:, :3], 3, axis=0) + rng.uniform(-0.3, 0.3, (len(fg), 3))
            fg[:, 10:13] = rng.normal(0, 0.5, (len(fg), 3))
            boxflow.save(token, lid, "boxflow", pool_box_flow(modar, fg))
            legacy.save(token, lid, "modar", modar)
            legacy.save(token, lid, "foreground", fg)
    return root


@pytest.mark.parametrize("db", ["boxflow", "legacy"])
def test_bandwidth_equals_jax(db, exchange_dbs, monkeypatch):
    jax_measure = _load("workspace/measure_exchange_size.py", "jax_measure_exchange_size")
    over = {"USE_SYNTHETIC_DATA": True, "MAX_POINTS_PER_SAMPLE": 4096, "MINI_TRAINVAL_STRIDE": 1,
            "SYNTHETIC": dict(SYN), "EXCHANGE_DATABASE_DIRECTORY": str(exchange_dbs / db)}
    late, lately = port_measure.measure_lately(dict(over), max_samples=6)
    assert late > 0 and lately > late
    assert (late, lately) == jax_measure.measure_lately(dict(over), max_samples=6)
    if db == "boxflow":  # neither reads the database
        early = port_measure.measure_early(dict(over), max_samples=3)
        assert early > 0 and early == jax_measure.measure_early(dict(over), max_samples=3)
        assert port_measure.measure_mid() == jax_measure.measure_mid() == 25.165824


def test_results_rows_are_the_jax_packages(monkeypatch):
    """Every row of ``workspace/collect_results.py``'s MATRIX, and its seed
    repeats, under the same label, config and train and eval tags."""
    jax_collect = _load("workspace/collect_results.py", "jax_collect_results",
                        argv=["collect_results.py", "synvf"], monkeypatch=monkeypatch)
    port = {label: (cfg, cols) for label, cfg, cols in collect_results.rows("synvf")}
    for label, cfg, cols in jax_collect.MATRIX:
        assert port[label] == (cfg, {c: spec for c, spec in cols.items() if spec}), label
    jax_seeds = {(label, col, name, spec) for label, _, seeds in jax_collect.SEED_REPEATS
                 for name, colmap in seeds.items() for col, spec in colmap.items()}
    port_seeds = {(label, col, name, (tt, et)) for label, _, col, seeds in
                  collect_results.seed_repeats("synvf") for name, tt, et in seeds}
    assert port_seeds == jax_seeds


def _cell(base, cfg, train_tag, eval_tag, m_ap, log="log_eval_x.txt"):
    base.mkdir(parents=True, exist_ok=True)
    (base / "metrics.json").write_text(json.dumps({"mAP": m_ap, "NDS": 0.5,
                                                   "recall/rcnn_0.3": 0.8}))
    (base / log).write_text("")


def test_results_table_names_the_feeding_car(tmp_path, monkeypatch):
    """On a results tree made here: a cell the senders fed shows the car
    of its own run, or for a carried cell the car its export kept, and no
    other cell shows one; the seed lines average each seed with the JAX
    package's line beside them; the bandwidth line; the export keeps the
    car beside each fed cell."""
    monkeypatch.setattr(collect_results, "ROOT_DIR", tmp_path)
    EGO, EARLY, LATE, CAR = (collect_results.EGO, collect_results.EARLY, collect_results.LATE,
                             collect_results.CAR)
    jax = tmp_path / "results" / "synvf"
    for (cfg, tt, et), m_ap in {(EGO, "synvf", "lately_sync"): 0.94,
                                (EGO, "synvf_s101", "lately_sync_s101"): 0.933,
                                (EGO, "synvf_s202", "lately_sync_s202"): 0.939,
                                (EGO, "synvf_oracle", "lately_oracle_sync"): 0.974,
                                (LATE, "synvf", "late_sync"): 0.858}.items():
        _cell(jax / f"{cfg}__{tt}__{et}", cfg, tt, et, m_ap)
    (jax / "bandwidth.json").write_text(json.dumps(
        {"early_MB": 1.7473, "late_MB": 0.00365, "lately_MB": 0.00486, "mid_disco_MB": 25.166}))
    run = tmp_path / "run"
    for (cfg, tt, et), m_ap in {(CAR, "synvf", "car"): 0.83, (LATE, "synvf", "late_sync"): 0.85,
                                (EGO, "synvf_oracle", "lately_oracle_sync"): 0.97,
                                (EGO, "synvf", "lately_drop05_sync"): 0.88,
                                (EGO, "synvf_s101", "lately_sync_s101"): 0.92,
                                (EARLY, "synvf_sync_s101", "early_sync_s101"): 0.96}.items():
        _cell(collect_results.eval_dir(run, cfg, tt, et), cfg, tt, et, m_ap, "log_eval_run.txt")
    export = tmp_path / "results" / "synvf_torch"
    _cell(export / f"{EGO}__synvf__lately_sync", EGO, "synvf", "lately_sync", 0.91)
    (export / f"{EGO}__synvf__lately_sync" / "fed_by.json").write_text(
        json.dumps({"mAP": 0.70, "eval_log": "log_eval_old.txt"}))
    _cell(export / f"{EGO}__synvf_s202__lately_sync_s202", EGO, "synvf_s202", "lately_sync_s202",
          0.93)
    (export / "bandwidth.json").write_text(json.dumps(
        {"early_MB": 1.7473, "late_MB": 0.004, "lately_MB": 0.0053, "mid_disco_MB": 25.166}))

    lines, out = collect_results.table(run, "synvf")

    def row(label):
        return next(l for l in lines if l.startswith(f"| {label} |")).split(" | ")

    assert row("late fusion")[1] == "85.0 (85.8) [car 83.0]"
    assert row("lately fusion (MoDAR, ours)")[1] == "91.0* (94.0) [car 70.0]"
    assert row("lately fusion (broadcast dropout p=0.5)")[1] == "88.0 [car 83.0]"
    assert row("lately fusion (oracle senders)")[1] == "97.0 (97.4)"
    assert "[car" not in "".join(row("per-agent car detector (own-view GT: not comparable to "
                                     "the rows above)"))
    assert out["late fusion"]["sync"]["car"] == {"mAP": 0.83, "eval_log": "log_eval_run.txt"}
    assert "car" not in out["lately fusion (oracle senders)"]["sync"]
    sync = next(l for l in lines if l.startswith("- lately fusion (MoDAR, ours) [sync]"))
    assert sync == ("- lately fusion (MoDAR, ours) [sync]: mAP 92.0 ± 1.0 (n=3: "
                    "base=91.0* [car 70.0], s101=92.0 [car 83.0], s202=93.0* [car ?]); "
                    "JAX 93.7 ± 0.3 (n=3)")
    # one seed of the early ego and none of the async lately ego: no line
    assert not any(l.startswith(("- early fusion", "- lately fusion (MoDAR, ours) [async]"))
                   for l in lines)
    assert ("Bandwidth, MB an ego sample receives (JAX in brackets): early 1.7473 (1.7473), "
            "late 0.004 (0.00365), lately 0.0053 (0.00486), mid (DiscoNet) 25.166 (25.166)") in lines
    assert out["bandwidth"]["late_MB"] == 0.004
    assert [r["mean"] for r in out["seed repeats"]] == pytest.approx([92.0])
    assert any("[seed s202]" in l and "lately_sync_s202" in l for l in lines)

    collect_results.export(run, "synvf", lines, out)
    fed = json.loads((export / f"{LATE}__synvf__late_sync" / "fed_by.json").read_text())
    assert fed == {"mAP": 0.83, "eval_log": "log_eval_run.txt"}
    assert not (export / f"{EGO}__synvf_oracle__lately_oracle_sync" / "fed_by.json").exists()
    assert (export / f"{EGO}__synvf_s101__lately_sync_s101" / "fed_by.json").exists()
    assert (export / f"{EARLY}__synvf_sync_s101__early_sync_s101" / "metrics.json").exists()
    saved = json.loads((export / "matrix.json").read_text())
    assert saved["seed repeats"][0]["seeds"]["s101"]["car"]["mAP"] == 0.83


STAGE = re.compile(r"^(train_|gen_exchange_|eval_)|^measure_bandwidth$")


def stage_names(path, calls):
    """The stage names of a pipeline script in order, read as text: ``for
    VAR in ...; do ... done`` loops unrolled, then each line that starts
    with a command of ``calls`` (name -> prefix of its stage name) taken
    with its first argument."""
    lines, out = Path(path).read_text().splitlines(), []
    i = 0
    unrolled = []
    while i < len(lines):
        loop = re.match(r"\s*for (\w+) in ([^;]+); do\s*$", lines[i])
        if not loop:
            unrolled.append(lines[i])
            i += 1
            continue
        end = next(j for j in range(i + 1, len(lines)) if lines[j].strip() == "done")
        for value in loop.group(2).split():
            unrolled += [re.sub(r"\$\{?%s\}?" % loop.group(1), value, l) for l in lines[i + 1:end]]
        i = end + 1
    for line in unrolled:
        m = re.match(r"\s*(\w+)\s+(\S+)", line)
        if m and m.group(1) in calls and not re.search(r"[$\"']", m.group(2)):
            name = calls[m.group(1)] + m.group(2)
            if STAGE.search(name):
                out.append(name)
    return out


def test_pipeline_has_every_jax_stage():
    jax = stage_names(REPO / "workspace" / "synth_experiments.sh",
                      {"run_stage": "", "ev": "eval_", "late": "eval_"})
    port = stage_names(REPO / "pcp_tpu_torch" / "workspace" / "synth_experiments.sh",
                       {"run_stage": "", "train": "", "gen": "", "ev": "eval_", "late": "eval_"})
    assert "train_ego_s202" in jax and "gen_exchange_loose_rsu" in jax and "measure_bandwidth" in jax
    assert len(jax) == len(set(jax)) == 52
    assert port == jax
