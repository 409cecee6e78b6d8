"""The port's data parallelism over ranks against its single-rank run and
the JAX package, on the CPU.

One launch of four gloo ranks (``parallel.launch.run_ranks``, the rank jobs
of ``parallel.workers``: they import neither jax nor this file) runs every
multi-rank case: the meshes of ``parallel/mesh.py``; the engine's ``mesh=``
at dp 4 and at dp 2 (ranks 0-1) on 6 and on 5 frames (batches dp does not
divide: the padding) and through ``process_directory`` over 10 PNG files at
batch 4; ``run_sharded_directory`` with ``merge_csv_shards`` on all four
ranks; the engine on a dp 2 x sp 2 mesh and on the (dp 1, tp 2) mesh of
``make_encoder_parallel_mesh("tp", 2)``. Two more launches, of two ranks, are
the flat-folder runner's own with ``--encoder-parallel sp
--parallel-devices 2`` and with ``tp``.

The JAX dp tests (``tests/test_parallel.py``) are marked slow, so the port's
single-rank run is held against the JAX single-device engine on the same
weights (one seed) and frames, and its dp runs against its single-rank run.
fp32 throughout, the tiny configs of ``tests/test_parallel.py:109-123``.
"""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synth import make_cell_image
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.parallel import multihost as jmultihost
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu_torch.apps import single_batch_inference as tapp
from yolo_sam_inference_tpu_torch.bench.common import write_png
from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS, METRIC_KEYS
from yolo_sam_inference_tpu_torch.parallel import mesh as tmesh
from yolo_sam_inference_tpu_torch.parallel import multihost as tmultihost
from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
from yolo_sam_inference_tpu_torch.parallel.workers import run_jobs
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

torch.set_num_threads(1)

OPTS = dict(batch_size=4, max_det=8, metric_crop=48, yolo_size=64, nms_candidates=64)
DP_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_parallel.py:146-149 (metrics 1e-4)
KEYS = ("boxes", "scores", "valid", "offsets", "mask_crops")


def _kwargs(**opts):
    return dict(device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1),
                seed=0, options=tengine.PipelineOptions(compute_dtype=torch.float32,
                                                        **{**OPTS, **opts}))


def _single():
    return tengine.CellSegmentationPipeline(**_kwargs())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of 4 gloo ranks: every job's inputs and rank outputs."""
    d = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(7)
    frames = [np.stack([make_cell_image(rng) for _ in range(n)]) for n in (6, 5)]
    paths = []
    for i, f in enumerate(frames):
        np.save(d / f"frames{i}.npy", f)
        paths.append(str(d / f"frames{i}.npy"))
    src = d / "in"
    src.mkdir()
    rng = np.random.default_rng(11)
    for i in range(10):  # 3 batches of 4: the timed sample, then the overlapped path
        write_png(src / f"f_{i}.png", make_cell_image(rng))
    jobs = [{"kind": "mesh_checks", "out": str(d / "mesh")}]
    for dp in (4, 2):
        jobs.append({"kind": "dp", "ranks": dp, "mesh": {"dp": dp}, "kwargs": _kwargs(),
                     "frames": paths, "dir": str(src), "outdir": str(d / f"dir{dp}"),
                     "out": str(d / f"dp{dp}")})
    jobs.append({"kind": "sharded", "kwargs": _kwargs(), "dir": str(src),
                 "outdir": str(d / "sharded"), "out": str(d / "sharded")})
    jobs.append({"kind": "dp", "mesh": {"dp": 2, "sp": 2}, "kwargs": _kwargs(encoder_parallel="sp"),
                 "frames": paths, "out": str(d / "dpsp")})
    jobs.append({"kind": "dp", "ranks": 2, "mesh": {"encoder_parallel": "tp", "devices": 2},
                 "kwargs": _kwargs(encoder_parallel="tp"), "frames": paths,
                 "out": str(d / "eptp")})
    backend = run_ranks(run_jobs, 4, (jobs,))
    single = _single()
    return {"d": d, "frames": frames, "src": src, "backend": backend, "single": single,
            "want": [single.process_batch_arrays(f) for f in frames],
            "want_dir": single.process_directory(src, d / "single", progress=False)}


def _json(d, prefix, rank):
    with open(d / f"{prefix}.rank{rank}.json") as f:
        return json.load(f)


def _rows_close(got, want):
    """Per-image cell rows of two runs: the same images and cells, ints
    exact, floats within 1e-4 (``tests/test_parallel.py:180-187``)."""
    assert [Path(p).name for p, _ in got] == [Path(p).name for p, _ in want]
    assert sum(len(cells) for _, cells in want) > 0
    for (_, gcells), (_, wcells) in zip(got, want):
        assert len(gcells) == len(wcells)
        for g, w in zip(gcells, wcells):
            for key in METRIC_KEYS:
                if key in INT_METRIC_KEYS:
                    assert g[key] == w[key], key
                else:
                    assert g[key] == pytest.approx(w[key], rel=1e-4, abs=1e-4), key


def test_make_mesh_shapes(runs):
    """The meshes on 4 ranks (``tests/test_parallel.py:22-28``), and without
    a process group in this process: one rank."""
    assert runs["backend"] == "gloo"
    infos = [_json(runs["d"], "mesh", r) for r in range(4)]
    for r, info in enumerate(infos):
        assert info["all"]["shape"] == {"dp": 4, "tp": 1} and info["all"]["size"] == 4
        assert info["all"]["groups"] == {"dp": 4, "tp": None}
        assert info["dp2"]["shape"] == {"dp": 2, "tp": 1}
        assert info["dp2"]["contains"] == (r < 2) and info["dp2"]["first"] == 0
        assert info["dp2"]["groups"] == ({"dp": 2, "tp": None} if r < 2 else {})
        assert "dp*tp = 3 != 4 devices" in info["dp3"]
        assert info["tp2"]["shape"] == {"dp": 2, "tp": 2}
        assert info["tp2"]["groups"] == {"dp": 2, "tp": 2}
        assert info["tp2"]["index"] == {"dp": r // 2, "tp": r % 2}
    mesh = tmesh.make_mesh()
    assert mesh.devices.size == 1 and mesh.shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="dp\\*tp = 6 != 1"):
        tmesh.make_mesh(dp=3, tp=2)
    with pytest.raises(ValueError, match="needs a torch.distributed process group"):
        tmesh.make_mesh(dp=2, ranks=[0, 1])


def test_make_encoder_parallel_mesh(runs):
    """The CLI mesh helper (``tests/test_parallel.py:528-540``): axis naming,
    0 = every rank, clear errors; the (dp 1, tp 2) mesh runs the engine with
    ``encoder_parallel="tp"`` on its two ranks, each returning the single
    rank's outputs."""
    for r, info in enumerate(_json(runs["d"], "mesh", r) for r in range(4)):
        assert info["sp_all"]["shape"] == {"dp": 1, "sp": 4}
        assert info["sp_all"]["groups"] == {"dp": None, "sp": 4}
        assert info["sp2"]["shape"] == {"dp": 1, "sp": 2} and info["sp2"]["contains"] == (r < 2)
        assert "visible devices" in info["ep_many"]
        assert "tp|sp" in info["ep_bogus"]
        assert info["ep_tp"]["shape"] == {"dp": 1, "tp": 2}
        assert info["ep_tp"]["contains"] == (r < 2)
        if r < 2:
            assert info["ep_tp"]["groups"] == {"dp": None, "tp": 2}
    assert tmesh.make_encoder_parallel_mesh("tp", 1).shape == {"dp": 1, "tp": 1}
    for r in range(2):
        _same_outputs(runs, "eptp", r)


def test_shard_batch_takes_the_rank_share():
    """``data_shard`` / ``shard_batch``: rank i's contiguous rows, as a JAX
    ``data_sharding`` places them (``tests/test_parallel.py:31-36``)."""
    mesh = tmesh.RankMesh(("dp", "tp"), np.arange(4).reshape(4, 1))
    x = np.arange(8 * 3).reshape(8, 3)
    assert tmesh.data_shard(mesh, 8) == slice(0, 2)  # this process is rank 0
    got = tmesh.shard_batch(mesh, {"x": x, "t": (x, x[:4])})
    np.testing.assert_array_equal(got["x"], x[:2])
    np.testing.assert_array_equal(got["t"][1], x[:1])
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.data_shard(mesh, 6)


def test_single_rank_matches_jax(runs):
    """The port's single-rank outputs on the 6 frames against the JAX
    single-device engine's on the same weights: the same detections; masks
    differ in few pixels, and a cell whose mask agrees has the same metrics
    (the tolerances of ``tests/test_torch_directory.py:113-118``)."""
    jp = jengine.CellSegmentationPipeline(
        sam_config=jax_tiny(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **OPTS))
    want = jp.process_batch_arrays(runs["frames"][0])
    got = runs["want"][0]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() > 0
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-3)
    same = 0
    for b, k in zip(*np.nonzero(got["valid"])):
        diff = int((got["mask_crops"][b, k] != want["mask_crops"][b, k]).sum())
        assert diff <= 0.01 * got["mask_crops"][b, k].size
        assert abs(got["metrics"]["area"][b, k] - want["metrics"]["area"][b, k]) <= diff
        if diff == 0:
            same += 1
            for key in METRIC_KEYS:
                np.testing.assert_allclose(got["metrics"][key][b, k], want["metrics"][key][b, k],
                                           rtol=1e-4, atol=1e-3, err_msg=key)
    assert same > 0


@pytest.mark.parametrize("dp", [4, 2])
def test_data_parallel_inference_matches_single_device(runs, dp):
    """``mesh=make_mesh(dp)`` on every rank: each returns the whole batch's
    outputs, equal to the single-rank run's, also where dp does not divide
    the batch (6 over 4, 5 over 4 and 2: the padding rows sliced off;
    ``tests/test_parallel.py:126-151``)."""
    d = runs["d"]
    for r in range(dp):
        with np.load(d / f"dp{dp}.rank{r}.npz") as got:
            for i, want in enumerate(runs["want"]):
                assert got[f"{i}/boxes"].shape[0] == len(runs["frames"][i])
                for key in KEYS:
                    np.testing.assert_allclose(got[f"{i}/{key}"], want[key], **DP_TOL,
                                               err_msg=f"rank {r} frames {i} {key}")
                for key in METRIC_KEYS:
                    np.testing.assert_allclose(got[f"{i}/metric_{key}"], want["metrics"][key],
                                               rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("dp", [4, 2])
def test_data_parallel_process_directory(runs, dp):
    """``process_directory`` under ``mesh=`` (``tests/test_parallel.py:
    154-192``): every rank's rows equal the single-rank run's; the ranks
    share one run id, and only rank 0 wrote the run directory's files."""
    d = runs["d"]
    infos = [_json(d, f"dp{dp}", r) for r in range(dp)]
    assert len({info["run_id"] for info in infos}) == 1
    assert [info["writes"] for info in infos] == [True] + [False] * (dp - 1)
    want = [[r.image_path, r.cell_metrics] for r in runs["want_dir"].results]
    for info in infos:
        _rows_close(info["rows"], want)
    (run_dir,) = (d / f"dir{dp}").iterdir()
    assert run_dir.name == infos[0]["run_id"]
    assert sorted(p.name for p in run_dir.iterdir()) == ["pipeline_parameters.json"]


def test_shard_file_list_partition():
    """``tests/test_parallel.py:89-94``, and the JAX function's shards."""
    files = [f"f{i}.png" for i in range(10)]
    shards = [tmultihost.shard_file_list(files, index=i, count=3) for i in range(3)]
    flat = sorted(str(f) for s in shards for f in s)
    assert flat == sorted(files)
    assert abs(len(shards[0]) - len(shards[2])) <= 1
    assert shards == [jmultihost.shard_file_list(files, index=i, count=3) for i in range(3)]
    assert tmultihost.process_info() == (0, 1)


def test_merge_csv_shards(tmp_path):
    """``tests/test_parallel.py:97-106``, and the JAX merge's bytes (pandas
    reads and writes them) on shards with a float column and a column one
    shard lacks."""
    for name, mod in (("port", tmultihost), ("jax", jmultihost)):
        out = tmp_path / name
        out.mkdir()
        for i in range(3):
            rows = "a,v\n" if i != 1 else "a,v,extra\n"
            rows += "".join(f"{i},{x!r}" + (",7" if i == 1 else "") + "\n"
                            for x in np.random.default_rng(i).normal(size=4).tolist())
            mod.shard_csv_path(out, "cell_metrics", i).write_text(rows)
    merged = {name: mod.merge_csv_shards(tmp_path / name, "cell_metrics")
              for name, mod in (("port", tmultihost), ("jax", jmultihost))}
    assert merged["port"].read_bytes() == merged["jax"].read_bytes()
    with open(merged["port"], newline="") as f:
        rows = list(csv.DictReader(f))
    assert sorted(int(r["a"]) for r in rows) == [0] * 4 + [1] * 4 + [2] * 4


def test_sharded_directory_and_merge(runs):
    """``run_sharded_directory`` on 4 ranks: each rank takes its stride of
    the files into one run directory; rank 0's merged ``cell_metrics.csv``
    and ``processing_times.csv`` hold the single-rank run's rows, once each,
    in shard order."""
    d = runs["d"]
    infos = [_json(d, "sharded", r) for r in range(4)]
    assert len({info["run_id"] for info in infos}) == 1
    names = sorted(p.name for p in runs["src"].iterdir())
    assert [[Path(p).name for p in info["files"]] for info in infos] == \
        [names[r::4] for r in range(4)]
    assert infos[0]["merged"][0] is not None and infos[1]["merged"] == [None, None]
    with open(infos[0]["merged"][0], newline="") as f:
        merged = list(csv.DictReader(f))
    want = {(Path(r.image_path).name, i): m for r in runs["want_dir"].results
            for i, m in enumerate(r.cell_metrics)}
    cells = {Path(r.image_path).name: r.num_cells for r in runs["want_dir"].results}
    order = [Path(p).name for info in infos for p in info["files"]]
    assert [r["image_name"] for r in merged] == [n for n in order for _ in range(cells[n])]
    assert len(merged) == len(want) > 0
    for row in merged:
        w = want[(row["image_name"], int(row["cell_id"]))]
        for key in METRIC_KEYS:
            assert float(row[key]) == pytest.approx(w[key], rel=1e-4, abs=1e-4), key
    with open(infos[0]["merged"][1], newline="") as f:
        assert sorted(r["image_name"] for r in csv.DictReader(f)) == names


def test_num_pipelines_maps_to_batch_multiplier():
    """``tests/test_parallel.py:216-232``."""
    pipe = tengine.ParallelCellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1),
        options=tengine.PipelineOptions(batch_size=3, yolo_size=64, compute_dtype=torch.float32),
        num_pipelines=4)
    assert pipe.options.batch_size == 12
    assert pipe.num_pipelines == 4
    assert pipe.mesh is None and pipe.writes


def _same_outputs(runs, prefix, rank):
    """A rank's outputs of both frame batches against the single rank's
    (the sp engine's tolerance, ``tests/test_torch_sp.py``)."""
    with np.load(runs["d"] / f"{prefix}.rank{rank}.npz") as z:
        for i, want in enumerate(runs["want"]):
            for key in KEYS:
                np.testing.assert_allclose(z[f"{i}/{key}"], want[key], rtol=1e-4, atol=1e-4,
                                           err_msg=key)
            for key in METRIC_KEYS:
                np.testing.assert_allclose(z[f"{i}/metric_{key}"], want["metrics"][key],
                                           rtol=1e-4, atol=1e-4, err_msg=key)


def test_mesh_refuses_dp_beside_sp(runs):
    """A data axis beside a sequence-parallel one (dp x sp) runs: each dp
    member's share through its sp pair's encoder; all four ranks return the
    single rank's outputs on both batches (6 and 5 frames: the padding)."""
    for r in range(4):
        _same_outputs(runs, "dpsp", r)
    mesh = tmesh.RankMesh(("dp", "sp"), np.arange(4).reshape(2, 2))
    pipe = tengine.CellSegmentationPipeline(**_kwargs(encoder_parallel="sp"), mesh=mesh)
    assert (pipe._dp, pipe._dp_axis) == (2, "dp")


RUNNER_KWARGS = dict(sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1),
                     options=dict(compute_dtype=torch.float32, sam_encoder_size=64, **OPTS))


def test_runner_encoder_parallel_sp(tmp_path, capsys):
    """The flat-folder runner with ``--encoder-parallel sp --parallel-devices
    2`` on 2 CPU ranks (its own launch): rc 0, one run directory written by
    rank 0, the CSV rows of the single-rank runner within the tolerance
    ``tests/test_torch_sp.py`` holds the sp engine to; ``tp`` parses too."""
    rng = np.random.default_rng(3)
    src = tmp_path / "in"
    src.mkdir()
    for i in range(5):
        write_png(src / f"im_{i}.png", make_cell_image(rng, 64, 64))
    base = ["--input-dir", str(src), "--device", "cpu", "--batch-size", "4", "--max-det", "8"]
    dirs = {}
    for name, extra in (("single", []), ("sp", ["--encoder-parallel", "sp",
                                                "--parallel-devices", "2"])):
        out = tmp_path / name
        assert tapp.main([*base, "--output-dir", str(out), *extra],
                         pipeline_kwargs=RUNNER_KWARGS) == 0
        (dirs[name],) = out.iterdir()
    files = {name: sorted(p.name for p in d.iterdir()) for name, d in dirs.items()}
    assert files["sp"] == files["single"] and "cell_metrics.csv" in files["sp"]
    rows = {}
    for name, d in dirs.items():
        with open(d / "cell_metrics.csv", newline="") as f:
            rows[name] = list(csv.DictReader(f))
    assert len(rows["sp"]) == len(rows["single"]) > 0
    for got, want in zip(rows["sp"], rows["single"]):
        assert list(got) == list(want)
        for key, value in want.items():
            if key in ("condition", "image_name", "cell_id") or key in INT_METRIC_KEYS:
                assert got[key] == value, key
            else:
                assert float(got[key]) == pytest.approx(float(value), rel=1e-4, abs=1e-4), key
    assert "Results written to" in capsys.readouterr().out
    assert tapp.parse_args([*base, "--output-dir", "o", "--encoder-parallel",
                            "tp"]).encoder_parallel == "tp"


def test_runner_encoder_parallel_tp(tmp_path):
    """The flat-folder runner with ``--encoder-parallel tp --parallel-devices
    2`` on 2 CPU ranks (its own launch): rc 0, rank 0's run directory holds
    the single-rank runner's files and rows."""
    rng = np.random.default_rng(6)
    src = tmp_path / "in"
    src.mkdir()
    for i in range(3):
        write_png(src / f"im_{i}.png", make_cell_image(rng, 64, 64))
    base = ["--input-dir", str(src), "--device", "cpu", "--batch-size", "4", "--max-det", "8"]
    rows = {}
    for name, extra in (("single", []), ("tp", ["--encoder-parallel", "tp",
                                                "--parallel-devices", "2"])):
        out = tmp_path / name
        assert tapp.main([*base, "--output-dir", str(out), *extra],
                         pipeline_kwargs=RUNNER_KWARGS) == 0
        (run_dir,) = out.iterdir()
        with open(run_dir / "cell_metrics.csv", newline="") as f:
            rows[name] = list(csv.DictReader(f))
    assert len(rows["tp"]) == len(rows["single"]) > 0
    for got, want in zip(rows["tp"], rows["single"]):
        for key, value in want.items():
            if key in ("condition", "image_name", "cell_id") or key in INT_METRIC_KEYS:
                assert got[key] == value, key
            else:
                assert float(got[key]) == pytest.approx(float(value), rel=1e-4, abs=1e-4), key


def test_pipeline_kwargs_reach_the_options():
    """``build_pipeline``: the runner's arguments, then ``pipeline_kwargs``'
    options over them."""
    args = tapp.parse_args(["--input-dir", "i", "--output-dir", "o", "--device", "cpu",
                            "--batch-size", "3", "--encoder-parallel", "sp"])
    seen = {}

    def cls(**kw):
        seen.update(kw)

    tapp.build_pipeline(cls, args, dict(RUNNER_KWARGS, seed=5), mesh="m", yolo_model_path=None)
    opts = seen["options"]
    assert (opts.batch_size, opts.max_det, opts.encoder_parallel, opts.sam_encoder_size) == \
        (4, 8, "sp", 64)
    assert (seen["seed"], seen["mesh"], seen["device"]) == (5, "m", "cpu")
    assert opts.compute_dtype == torch.float32


def test_project_runner_encoder_parallel_sp(tmp_path):
    """The project runner with ``--encoder-parallel sp --parallel-devices 2``
    on 2 CPU ranks: the ROIs resolved once, in the parent; rank 0 writes the
    single-rank run's file set, and its combined and gated CSVs hold the
    single-rank rows."""
    from yolo_sam_inference_tpu_torch.apps import project_inference as tproject

    rng = np.random.default_rng(4)
    for cond in ("a", "b"):
        (tmp_path / "p" / cond / "batch_1").mkdir(parents=True)
        for i in range(2):
            write_png(tmp_path / "p" / cond / "batch_1" / f"f_{i}.png",
                      make_cell_image(rng, 64, 64))
    base = ["--project-dir", str(tmp_path / "p"), "--device", "cpu", "--roi", "0,40",
            "--batch-size", "2", "--max-det", "8"]
    trees, rows = {}, {}
    for name, extra in (("single", []), ("sp", ["--encoder-parallel", "sp",
                                                "--parallel-devices", "2"])):
        out = tmp_path / name
        assert tproject.main([*base, "--output-dir", str(out), *extra],
                             pipeline_kwargs=RUNNER_KWARGS) == 0
        (run_dir,) = out.iterdir()
        trees[name] = sorted(str(p.relative_to(run_dir)).replace(run_dir.name, "RUN")
                             for p in run_dir.rglob("*") if p.is_file())
        rows[name] = {}
        for csv_name in ("cell_metrics.csv", "gated_cell_metrics.csv"):
            with open(run_dir / csv_name, newline="") as f:
                rows[name][csv_name] = list(csv.DictReader(f))
    assert trees["sp"] == trees["single"]
    assert "gated_cell_metrics.csv" in trees["sp"] and "a/RUN/cell_metrics.csv" in trees["sp"]
    for csv_name, want in rows["single"].items():
        got = rows["sp"][csv_name]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for key, value in w.items():
                try:
                    assert float(g[key]) == pytest.approx(float(value), rel=1e-4, abs=1e-4), key
                except ValueError:
                    assert g[key] == value, key
    assert len(rows["sp"]["cell_metrics.csv"]) > 0
