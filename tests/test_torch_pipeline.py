"""The port's pipeline as a whole against the JAX package, on the CPU.

Both ``CellSegmentationPipeline``s, the same seed and the same frames, fp32,
at a tiny size: ``sam_tiny_test()`` (adapted to window 16 on a 32x32 grid),
YOLOv8n at a 64-pixel letterbox, two 64x64 ``tests/synth.py`` frames.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synth import make_cell_image
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPTS = dict(batch_size=2, yolo_size=64, max_det=4, metric_crop=48, nms_candidates=64)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    frames = np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])
    jp = jengine.CellSegmentationPipeline(
        sam_config=jax_tiny(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **OPTS),
    )
    tp = tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1),
        seed=0, options=tengine.PipelineOptions(compute_dtype=torch.float32, **OPTS),
    )
    return frames, jp, tp, jp.process_batch_arrays(frames), tp.process_batch_arrays(frames)


def test_outputs_schema(both):
    frames, _, tp, _, out = both
    b, k, cm = 2, OPTS["max_det"], OPTS["metric_crop"]
    assert out["boxes"].shape == (b, k, 4) and out["scores"].shape == (b, k)
    assert out["valid"].dtype == bool and out["mask_crops"].shape == (b, k, cm, cm)
    assert out["offsets"].shape == (b, k, 2)
    assert sorted(out["metrics"]) == sorted(METRIC_KEYS)
    assert all(np.isfinite(v).all() for v in out["metrics"].values())
    results = tp._results_from_outputs(out, [f"f{i}.png" for i in range(b)], b)
    assert [r.num_cells for r in results] == list(out["valid"].sum(axis=1))
    assert all(isinstance(r.cell_metrics[0]["area"], int) for r in results if r.num_cells)


def test_detections_match_jax(both):
    _, _, _, jo, to = both
    np.testing.assert_array_equal(to["valid"], jo["valid"])
    assert jo["valid"].sum() > 0
    # fp32 YOLO in another summation order: boxes in pixels, scores sigmoid
    np.testing.assert_allclose(to["boxes"], jo["boxes"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(to["scores"], jo["scores"], rtol=1e-5, atol=1e-5)


def test_segment_and_metrics_on_jax_boxes(both):
    """JAX boxes into the port's segment + metrics stages (an NMS near-tie
    cannot cascade): mask crops agree on >= 99.5% of pixels; metrics of
    identical masks agree to fp32 rounding; areas differ by at most the
    number of differing pixels."""
    frames, jp, tp, jo, _ = both
    h, w = frames.shape[1:3]
    jst, tst = jp._stages(h, w), tp._stages(h, w)
    img = torch.from_numpy(frames)
    with torch.inference_mode():
        emb = tst["embed"](img)
        crops, offs = tst["segment"](emb, torch.from_numpy(np.array(jo["boxes"])),
                                     torch.from_numpy(np.array(jo["valid"])))
        mets = tst["metrics"](crops, offs, tengine._gray_f32(img))
    jemb = jst["embed"](jst["sam_params"], jnp.asarray(frames))
    # fp32 encoders, window partition (JAX CPU path) vs grid
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(offs.numpy(), jo["offsets"])
    crops = crops.numpy()
    agree = crops == jo["mask_crops"]
    assert agree.mean() >= 0.995, agree.mean()
    same = agree.all(axis=(2, 3))
    for key in METRIC_KEYS:
        got, want = mets[key].numpy(), jo["metrics"][key]
        np.testing.assert_allclose(got[same], want[same], rtol=1e-4, atol=1e-3, err_msg=key)
    diff_px = (~agree).sum(axis=(2, 3))
    assert (np.abs(mets["area"].numpy() - jo["metrics"]["area"]) <= diff_px).all()


def test_cuda_pipeline_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.CellSegmentationPipeline(device="cuda", sam_config=sam_tiny_test())


def _run_smoke(script, cwd):
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout  # no result line on failure
    return proc


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = _run_smoke(lone, tmp_path)
    assert "yolo_sam_inference_tpu_torch/ not found" in proc.stderr


def test_port_imports_no_jax():
    """The port (its pipeline, the directory path's modules, the multi-rank
    modules its spawned ranks import, the classical pipeline, the lab apps,
    the results store, the tp / pp encoders, the fine-tune step and the
    parameter checkpoints) and ``chip_smoke.py`` must import neither jax nor
    the JAX package, and the results store and the multi-rank modules
    neither pandas nor PIL:
    the script is imported, and every import statement in it, those inside
    its phase functions (the ``[classical]`` phase's too) as well, is read
    from its syntax tree. Nothing in the port opens a path under ``native/``
    for writing: with every write-mode open, ``os.replace`` and compiler
    output path watched, the port builds its PNG decoder and its images.bin
    reader afresh (into temporary build roots), decodes a PNG through the
    loader's call and reads a stream."""
    code = (
        "import ast, builtins, io, os, subprocess, sys, pkgutil, importlib, tempfile\n"
        "native = os.path.realpath('native') + os.sep\n"
        "writes = []\n"
        "def under(p):\n"
        "    return isinstance(p, (str, bytes, os.PathLike)) and \\\n"
        "        os.path.realpath(os.fsdecode(p)).startswith(native)\n"
        "_open, _os_open, _replace = builtins.open, os.open, os.replace\n"
        "def watched_open(f, mode='r', *a, **k):\n"
        "    if any(c in mode for c in 'wax+') and under(f): writes.append(f)\n"
        "    return _open(f, mode, *a, **k)\n"
        "def watched_os_open(p, flags, *a, **k):\n"
        "    if flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT) and under(p): writes.append(p)\n"
        "    return _os_open(p, flags, *a, **k)\n"
        "def watched_replace(s, d, *a, **k):\n"
        "    if under(d): writes.append(d)\n"
        "    return _replace(s, d, *a, **k)\n"
        "_init = subprocess.Popen.__init__\n"
        "def watched_popen(self, args, *a, **k):\n"
        "    if isinstance(args, (list, tuple)) and '-o' in args and \\\n"
        "            under(args[list(args).index('-o') + 1]): writes.append(args)\n"
        "    return _init(self, args, *a, **k)\n"
        "builtins.open = io.open = watched_open\n"
        "os.open, os.replace, subprocess.Popen.__init__ = watched_os_open, watched_replace, \\\n"
        "    watched_popen\n"
        "import yolo_sam_inference_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import yolo_sam_inference_tpu_torch.pipeline.engine\n"
        "import chip_smoke\n"
        "walked = {'yolo_sam_inference_tpu_torch.' + m for m in (\n"
        "    'parallel.sp', 'parallel.launch', 'parallel.workers', 'io.images', 'io.png_native',\n"
        "    'io.tiff', 'io.deflate', 'pipeline.loader', 'pipeline.visualize', 'reporting',\n"
        "    'utils.image_utils', 'utils.metrics_reporter', 'apps.single_batch_inference',\n"
        "    'bench.e2e', 'ops.morphology', 'io.images_bin', 'classical.pipeline', 'classical.viz',\n"
        "    'classical.ms_process', 'apps.opencv_project_inference', 'apps.ms_opencv_process',\n"
        "    'web.app', 'gate.picker', 'apps.plot_scatter', 'apps.deformability_training_data',\n"
        "    'apps.tiff2png', 'apps.make_example_project', 'registry.manifest', 'registry.nodes',\n"
        "    'registry.readout', 'registry.postgres', 'apps.manifest_cli', 'apps.batch_readout',\n"
        "    'apps.result_viewer', 'parallel.mesh', 'parallel.multihost',\n"
        "    'apps.project_inference', 'parallel.tp', 'parallel.pp', 'parallel.train',\n"
        "    'parallel.dryrun', 'ops.autograd', 'utils.checkpoint')}\n"
        "assert walked <= set(sys.modules), sorted(walked - set(sys.modules))\n"
        "for m in walked:\n"  # the results store and the ranks' modules: no pandas, no PIL
        "    if m.split('.')[1] in ('registry', 'parallel') or m in (\n"
        "            'yolo_sam_inference_tpu_torch.apps.' + a for a in (\n"
        "            'manifest_cli', 'batch_readout', 'result_viewer')):\n"
        "        mod = ast.parse(open(sys.modules[m].__file__).read())\n"
        "        used = [a.name for n in ast.walk(mod) if isinstance(n, ast.Import)\n"
        "                for a in n.names]\n"
        "        used += [n.module or '' for n in ast.walk(mod) if isinstance(n, ast.ImportFrom)]\n"
        "        assert not [u for u in used if u.split('.')[0] in ('pandas', 'PIL')], (m, used)\n"
        "from yolo_sam_inference_tpu_torch.bench.common import write_png\n"
        "from yolo_sam_inference_tpu_torch.io import png_native\n"
        "from yolo_sam_inference_tpu_torch.pipeline.loader import _safe_load\n"
        "assert not under(png_native.BUILD_ROOT), png_native.BUILD_ROOT\n"
        "tmp = tempfile.mkdtemp()\n"
        "png_native.BUILD_ROOT = png_native.Path(tmp) / 'build'\n"
        "png_native._load.cache_clear()\n"
        "write_png(tmp + '/f.png', __import__('numpy').full((8, 9), 7, 'uint8'))\n"
        "assert _safe_load(png_native.Path(tmp + '/f.png')).shape == (8, 9)\n"
        "assert not writes, writes\n"
        "assert png_native.library_path().is_file(), png_native.library_path()\n"
        "from yolo_sam_inference_tpu_torch.io import images_bin\n"
        "assert not under(images_bin.BUILD_ROOT), images_bin.BUILD_ROOT\n"
        "images_bin.BUILD_ROOT = images_bin.Path(tmp) / 'build_images_bin'\n"
        "images_bin._load.cache_clear()\n"
        "images_bin.write_images_bin(tmp + '/images.bin', [__import__('numpy').ones((4, 5), 'uint8')])\n"
        "assert images_bin.read_frames_gray8(tmp + '/images.bin').shape == (1, 4, 5)\n"
        "assert not writes, writes\n"
        "assert images_bin.library_path().is_file(), images_bin.library_path()\n"
        "tree = ast.parse(open('chip_smoke.py').read())\n"
        "names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]\n"
        "names += [n.module or '' for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]\n"
        "assert 'yolo_sam_inference_tpu_torch.pipeline' in names, names\n"
        "assert {'yolo_sam_inference_tpu_torch.classical.pipeline',\n"
        "        'yolo_sam_inference_tpu_torch.web.app', 'yolo_sam_inference_tpu_torch.registry.nodes',\n"
        "        'yolo_sam_inference_tpu_torch.apps.result_viewer',\n"
        "        'yolo_sam_inference_tpu_torch.parallel.mesh',\n"
        "        'yolo_sam_inference_tpu_torch.parallel.multihost',\n"
        "        'yolo_sam_inference_tpu_torch.parallel.tp',\n"
        "        'yolo_sam_inference_tpu_torch.parallel.pp',\n"
        "        'yolo_sam_inference_tpu_torch.parallel.train',\n"
        "        'yolo_sam_inference_tpu_torch.parallel.dryrun'} <= set(names), names\n"
        "bad = [m for m in list(sys.modules) + names\n"
        "       if m in ('jax', 'jaxlib', 'yolo_sam_inference_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib.', 'yolo_sam_inference_tpu.'))]\n"
        "print(sorted(bad))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", ["pipeline/engine.py", "weights.py"])
def test_engine_names_no_sam_family(path):
    """The engine and the weight bridge ask a configuration for its family's
    answers (``models/sam/config.py``) and name no family themselves."""
    text = (ROOT / "yolo_sam_inference_tpu_torch" / path).read_text()
    named = re.findall(r"Sam2Config|TinyViTConfig|is_tinyvit|TINYVIT_TYPES|init_sam2_params|"
                       r"init_tinyvit_params|_sam2", text)
    assert not named, named
