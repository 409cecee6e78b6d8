"""The port's checkpoint loading against the JAX package, on the CPU.

Converters: the same state dicts through both packages' converters give the
same trees leaf for leaf (``np.array_equal``, dtypes too): a tiny HF
``SamModel`` (``test_sam_parity.py``), a torch TinyViT in the official
naming with an original-naming decoder (``test_tinyvit_parity.py``), and
ultralytics dicts for YOLOv8n and v8s (``test_yolo.py``). The MobileSAM
converter also without the ``attention_bias_idxs`` buffers, which the public
code registers ``persistent=False``. ``bench/checkpoints.py``'s generators
follow those public namings key for key. The engine and the runner run from
files written here, beside the JAX engine on the same files.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synth import make_cell_image
from test_sam_parity import torch_sam  # noqa: F401  (pytest fixture)
from test_tinyvit_parity import TinyViTConfig as JaxTinyViTConfig
from test_tinyvit_parity import TorchTinyViT, _hf_to_original_naming, _randomize
from test_torch_models import _assert_same_tree
from test_torch_pipeline import ROOT
from test_yolo import _fake_ultralytics_state_dict
from yolo_sam_inference_tpu.models.sam import convert as jconvert
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.models.yolo import convert as jyconvert
from yolo_sam_inference_tpu.models.yolo import yolov8n as jyolov8n
from yolo_sam_inference_tpu.models.yolo import yolov8s as jyolov8s
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu.utils import mask_encoding as jmask_encoding
from yolo_sam_inference_tpu_torch.bench import checkpoints
from yolo_sam_inference_tpu_torch.models.sam import TinyViTConfig, sam_tiny_test
from yolo_sam_inference_tpu_torch.models.sam import convert as tconvert
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig, yolov8m, yolov8n, yolov8s
from yolo_sam_inference_tpu_torch.models.yolo import convert as tyconvert
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.utils import mask_encoding as tmask_encoding
from yolo_sam_inference_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

YOLO_CONFIGS = {"yolov8n": (yolov8n, jyolov8n), "yolov8s": (yolov8s, jyolov8s)}
# the mask-prompt path's original segment-anything names (no converter reads it)
MASK_DOWNSCALING = {"mask_embed.conv1": "mask_downscaling.0", "mask_embed.norm1":
                    "mask_downscaling.1", "mask_embed.conv2": "mask_downscaling.3",
                    "mask_embed.norm2": "mask_downscaling.4", "mask_embed.conv3":
                    "mask_downscaling.6"}


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def _original_naming(hf_sd):
    out = {}
    for k, v in _hf_to_original_naming(hf_sd).items():
        for a, b in MASK_DOWNSCALING.items():
            k = k.replace(a, b)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def torch_tinyvit():
    cfg = JaxTinyViTConfig(image_size=256, output_channels=16)
    model = TorchTinyViT(256, cfg)
    _randomize(model, 7)
    return model.eval()


@pytest.fixture(scope="module")
def mobilesam_sd(torch_sam, torch_tinyvit):  # noqa: F811
    sd = _original_naming(torch_sam.state_dict())
    sd.update({f"image_encoder.{k}": v for k, v in torch_tinyvit.state_dict().items()})
    return sd


def _without_bias_idxs(sd):
    return {k: v for k, v in sd.items() if not k.endswith("attention_bias_idxs")}


# ------------------------------------------------------------------- SAM


def test_hf_sam_converter_matches_jax(torch_sam):  # noqa: F811
    sd = torch_sam.state_dict()
    _assert_same_tree(tconvert.convert_hf_sam_state_dict(sd, sam_tiny_test()),
                      jconvert.convert_hf_sam_state_dict(sd, jax_tiny()))


@pytest.mark.parametrize("image_size", [64, 128])
@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_load_sam_params_matches_jax(torch_sam, tmp_path, fmt, image_size):  # noqa: F811
    """A torch file and a safetensors file; at the checkpoint's own canvas
    and at twice it (adapt_resolution: the grid 8 -> 16, the global tables
    15 -> 31 rows)."""
    sd = {k: v.detach().clone() for k, v in torch_sam.state_dict().items()}
    path = tmp_path / f"sam.{fmt}"
    if fmt == "pt":
        torch.save(sd, path)
    else:
        from safetensors.numpy import save_file

        save_file({k: v.numpy() for k, v in sd.items()}, str(path))
    tcfg = dataclasses.replace(sam_tiny_test(), image_size=image_size)
    jcfg = dataclasses.replace(jax_tiny(), image_size=image_size)
    got = tconvert.load_sam_params(str(path), tcfg)
    _assert_same_tree(got, jconvert.load_sam_params(str(path), jcfg))
    assert got["vision"]["pos_embed"].shape[1] == image_size // 8


@pytest.mark.parametrize("bias_idxs", ["kept", "removed"])
def test_mobilesam_converter_matches_jax(mobilesam_sd, bias_idxs):
    """The port's tree equals JAX's on the official naming; with every
    ``attention_bias_idxs`` removed the port rebuilds the index from the
    window size and gives the same tree (JAX, which needs the buffer, is
    given the full dict)."""
    sd = mobilesam_sd if bias_idxs == "kept" else _without_bias_idxs(mobilesam_sd)
    tcfg = TinyViTConfig(image_size=256, output_channels=16)
    jcfg = JaxTinyViTConfig(image_size=256, output_channels=16)
    got = tconvert.convert_mobilesam_state_dict(sd, sam_tiny_test(), tcfg)
    want = jconvert.convert_mobilesam_state_dict(mobilesam_sd, jax_tiny(), jcfg)
    _assert_same_tree(got, want)
    assert np.abs(got["tinyvit"]["stage1"][0]["attn"]["attn_bias"]).max() > 0


def test_abs_offset_index_is_the_official_buffer(torch_tinyvit):
    for si in (1, 2, 3):
        attn = torch_tinyvit.layers[si].blocks[0].attn
        ws = int(round(attn.attention_bias_idxs.shape[0] ** 0.5))
        np.testing.assert_array_equal(tconvert.abs_offset_index(ws),
                                      attn.attention_bias_idxs.numpy())


@pytest.mark.parametrize("which", ["hf", "mobilesam", "yolo", "empty"])
def test_is_mobilesam_state_dict_matches_jax(torch_sam, mobilesam_sd, which):  # noqa: F811
    sd = {"hf": torch_sam.state_dict(), "mobilesam": mobilesam_sd,
          "yolo": checkpoints.ultralytics_state_dict(yolov8n(), 0), "empty": {}}[which]
    assert tconvert.is_mobilesam_state_dict(sd) == jconvert.is_mobilesam_state_dict(sd) == \
        (which == "mobilesam")


# ------------------------------------------------------------------ YOLO


@pytest.mark.parametrize("name", sorted(YOLO_CONFIGS))
def test_yolo_converter_matches_jax(name, tmp_path):
    tcfg, jcfg = (f() for f in YOLO_CONFIGS[name])
    sd = _fake_ultralytics_state_dict(jcfg)
    want = jyconvert.convert_ultralytics_state_dict(sd, jcfg)
    _assert_same_tree(tyconvert.convert_ultralytics_state_dict(sd, tcfg), want)
    torch.save(sd, tmp_path / "yolo.pt")
    _assert_same_tree(tyconvert.load_yolo_params(str(tmp_path / "yolo.pt"), tcfg), want)


def test_yolo_configs_match_jax():
    from yolo_sam_inference_tpu.models.yolo import config as jyconfig

    for port, jax_fn in ((yolov8n, jyconfig.yolov8n), (yolov8s, jyconfig.yolov8s),
                         (yolov8m, jyconfig.yolov8m)):
        assert dataclasses.asdict(port()) == dataclasses.asdict(jax_fn())


def test_load_yolo_params_refuses_a_pickled_module(tmp_path):
    """A full pickled checkpoint needs ``allow_pickle=True`` in both."""
    path = tmp_path / "full.pt"
    torch.save({"model": torch.nn.Linear(2, 2)}, path)
    for load, cfg in ((tyconvert.load_yolo_params, yolov8n()),
                      (jyconvert.load_yolo_params, jyolov8n())):
        with pytest.raises(ValueError, match="allow_pickle=True"):
            load(str(path), cfg)


# ------------------------------------------------------------ generators


@pytest.mark.parametrize("which", ["hf", "mobilesam", "yolov8n", "yolov8s"])
def test_generators_follow_public_naming(torch_sam, mobilesam_sd, which):  # noqa: F811
    """``bench/checkpoints.py`` writes the keys and shapes of the public
    models: HF ``SamModel``, official TinyViT + original segment-anything
    (the mask prompt's ``mask_downscaling`` included), ultralytics."""
    if which == "hf":
        got, want = checkpoints.hf_sam_state_dict(sam_tiny_test(), 3), torch_sam.state_dict()
    elif which == "mobilesam":
        got = checkpoints.mobilesam_state_dict(
            TinyViTConfig(image_size=256, output_channels=16), sam_tiny_test(), 3)
        want = mobilesam_sd
    else:
        got = checkpoints.ultralytics_state_dict(YOLO_CONFIGS[which][0](), 3)
        want = _fake_ultralytics_state_dict(YOLO_CONFIGS[which][1]())
    assert _shapes(got) == _shapes(want)


@pytest.mark.parametrize("which", ["hf", "mobilesam", "yolov8s"])
def test_generated_dicts_convert_like_jax(which):
    """The generated dicts through both converters (MobileSAM's without its
    index buffers on the port's side); the converted trees build the port's
    modules in fp32."""
    if which == "hf":
        sd = checkpoints.hf_sam_state_dict(sam_tiny_test(), 5)
        got = tconvert.convert_hf_sam_state_dict(sd, sam_tiny_test())
        want = jconvert.convert_hf_sam_state_dict(sd, jax_tiny())
    elif which == "mobilesam":
        tcfg = TinyViTConfig(image_size=256, output_channels=16)
        sd = checkpoints.mobilesam_state_dict(tcfg, sam_tiny_test(), 5)
        got = tconvert.convert_mobilesam_state_dict(_without_bias_idxs(sd), sam_tiny_test(),
                                                    tcfg)
        want = jconvert.convert_mobilesam_state_dict(
            sd, jax_tiny(), JaxTinyViTConfig(image_size=256, output_channels=16))
    else:
        sd = checkpoints.ultralytics_state_dict(yolov8s(), 5)
        got = tyconvert.convert_ultralytics_state_dict(sd, yolov8s())
        want = jyconvert.convert_ultralytics_state_dict(sd, jyolov8s())
    _assert_same_tree(got, want)
    if which == "yolov8s":
        yolo, _ = from_jax_params(got, None, "cpu", yolo_config=yolov8s())
        mods = [yolo]
    else:
        cfg = sam_tiny_test()
        if which == "mobilesam":
            cfg = dataclasses.replace(cfg, image_size=256, patch_size=16)
        _, sam = from_jax_params(None, got, "cpu", sam_config=cfg)
        mods = [sam]
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for m in mods for p in m.parameters())


# --------------------------------------------------------------- engine

OPTS = dict(batch_size=2, yolo_size=64, max_det=4, metric_crop=48, nms_candidates=64,
            conf_threshold=0.0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Checkpoint files of the tiny SAM (HF naming), a tiny-decoder MobileSAM
    and YOLOv8n, written by ``bench/checkpoints.py``; two 64x64 frames."""
    tmp = tmp_path_factory.mktemp("ckpt")
    mcfg = dataclasses.replace(sam_tiny_test(), image_size=64, patch_size=16)
    out = {"sam": tmp / "sam.pt", "mobile": tmp / "mobile_sam.pt", "yolo": tmp / "yolo.pt"}
    torch.save(checkpoints.hf_sam_state_dict(sam_tiny_test(), 11), out["sam"])
    torch.save(checkpoints.mobilesam_state_dict(
        TinyViTConfig(image_size=64, output_channels=16), mcfg, 12, with_bias_idxs=False),
        out["mobile"])
    mob_idx = checkpoints.mobilesam_state_dict(
        TinyViTConfig(image_size=64, output_channels=16), mcfg, 12)
    torch.save(mob_idx, tmp / "mobile_sam_idxs.pt")  # the JAX converter needs the buffers
    out["mobile_idxs"] = tmp / "mobile_sam_idxs.pt"
    torch.save(checkpoints.ultralytics_state_dict(YoloConfig(num_classes=1), 13), out["yolo"])
    rng = np.random.default_rng(0)
    out["frames"] = np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])
    return out


def _pipes(files, model="facebook/sam-vit-base", **opts):
    mobile = model == "mobile-sam"
    scfg = dataclasses.replace(sam_tiny_test(), image_size=64, patch_size=16) if mobile \
        else sam_tiny_test()
    jcfg = dataclasses.replace(jax_tiny(), image_size=64, patch_size=16) if mobile \
        else jax_tiny()
    extra = dict(sam_encoder_size=64) if mobile else {}
    jp = jengine.CellSegmentationPipeline(
        yolo_model_path=str(files["yolo"]), sam_model_type=model, sam_config=jcfg,
        yolo_config=JaxYoloConfig(num_classes=1),
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **OPTS, **extra, **opts))
    # the JAX engine's own sam_checkpoint path raises on any SAM file (its
    # tree_map takes the tree's lists for leaves, engine.py:555-559): its
    # SAM tree is set from the JAX converter on the same file instead
    jp.sam_params = jconvert.load_sam_params(str(files["mobile_idxs" if mobile else "sam"]),
                                             jcfg)
    tp = tengine.CellSegmentationPipeline(
        yolo_model_path=files["yolo"], sam_model_type=model,
        sam_checkpoint=files["mobile" if mobile else "sam"], device="cpu", sam_config=scfg,
        yolo_config=YoloConfig(num_classes=1),
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **OPTS, **extra, **opts))
    return jp, tp


@pytest.mark.parametrize("model,hull_mode", [("facebook/sam-vit-base", "polygon"),
                                             ("facebook/sam-vit-base", "reference"),
                                             ("mobile-sam", "polygon")])
def test_engine_from_files_matches_jax(files, model, hull_mode):
    """Both engines on the same files: the trees equal, detections, boxes
    and scores to the tolerances of ``test_torch_pipeline.py``, mask crops on
    >= 99.5% of pixels and the metrics of identical masks to fp32 rounding,
    in both hull modes."""
    jp, tp = _pipes(files, model, hull_mode=hull_mode)
    _assert_same_tree(tp.yolo_params, jyconvert.load_yolo_params(str(files["yolo"]),
                                                                 JaxYoloConfig(num_classes=1)))
    _assert_same_tree(tp.sam_params, jp.sam_params)
    frames = files["frames"]
    jo, to = jp.process_batch_arrays(frames), tp.process_batch_arrays(frames)
    np.testing.assert_array_equal(to["valid"], jo["valid"])
    assert jo["valid"].sum() > 0
    np.testing.assert_allclose(to["boxes"], jo["boxes"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(to["scores"], jo["scores"], rtol=1e-5, atol=1e-5)
    agree = to["mask_crops"] == jo["mask_crops"]
    assert agree.mean() >= 0.995, agree.mean()
    same = agree.all(axis=(2, 3)) & jo["valid"]
    assert same.sum() > 0 and (to["metrics"]["area"][same] > 0).any()
    for key, want in jo["metrics"].items():
        np.testing.assert_allclose(to["metrics"][key][same], want[same], rtol=1e-4, atol=1e-3,
                                   err_msg=key)


@pytest.mark.parametrize("which", ["yolo_model_path", "sam_checkpoint"])
def test_missing_checkpoint_raises(files, tmp_path, which):
    """A path that does not exist raises; nothing falls back to random
    weights (the JAX engine logs a warning and draws them)."""
    paths = {"yolo_model_path": files["yolo"], "sam_checkpoint": files["sam"],
             which: tmp_path / "missing.pt"}
    with pytest.raises(FileNotFoundError, match="missing.pt"):
        tengine.CellSegmentationPipeline(device="cpu", sam_config=sam_tiny_test(),
                                         yolo_config=YoloConfig(num_classes=1), **paths)


@pytest.mark.parametrize("case", ["params and a file", "mobile-sam from a ViT file"])
def test_engine_refuses_ambiguous_weights(files, case):
    kw = dict(device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1))
    if case == "params and a file":
        with pytest.raises(ValueError, match="params"):
            tengine.CellSegmentationPipeline(yolo_model_path=files["yolo"],
                                             params=({}, {}), **kw)
    else:
        with pytest.raises(ValueError, match="no TinyViT"):
            tengine.CellSegmentationPipeline(sam_model_type="mobile-sam",
                                             sam_checkpoint=files["sam"], **kw)


def test_parallel_pipeline_passes_files_through(files):
    pipe = tengine.ParallelCellSegmentationPipeline(
        yolo_model_path=files["yolo"], sam_checkpoint=files["sam"], device="cpu",
        sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), num_pipelines=2,
        options=tengine.PipelineOptions(batch_size=2, hull_mode="reference"))
    _, single = _pipes(files)
    _assert_same_tree(pipe.sam_params, single.sam_params)
    assert pipe.options.batch_size == 4 and pipe.options.hull_mode == "reference"


# ---------------------------------------------------------------- runner


def _tiny_runner_pipes(monkeypatch):
    """The runner's pipeline class at the tiny configs, fp32."""
    cls = tengine.CellSegmentationPipeline

    def make(**kw):
        opts = dataclasses.replace(kw.pop("options"), compute_dtype=torch.float32,
                                   **{k: v for k, v in OPTS.items() if k != "batch_size"})
        return cls(**kw, options=opts, sam_config=sam_tiny_test(),
                   yolo_config=YoloConfig(num_classes=1))
    monkeypatch.setattr(tengine, "CellSegmentationPipeline", make)


def test_runner_from_files_in_reference_mode(files, tmp_path, monkeypatch):
    from yolo_sam_inference_tpu_torch.apps import single_batch_inference as tapp
    from yolo_sam_inference_tpu_torch.bench.common import write_png

    _tiny_runner_pipes(monkeypatch)
    src = tmp_path / "in"
    src.mkdir()
    for i, im in enumerate(files["frames"]):
        write_png(src / f"im_{i}.png", im)
    out = tmp_path / "out"
    assert tapp.main(["--input-dir", str(src), "--output-dir", str(out), "--device", "cpu",
                      "--yolo-model", str(files["yolo"]), "--sam-checkpoint",
                      str(files["sam"]), "--hull-mode", "reference", "--batch-size", "2"]) == 0
    (run_dir,) = out.iterdir()
    rows = (run_dir / "cell_metrics.csv").read_text().splitlines()
    assert len(rows) > 1 and "deformability" in rows[0]
    assert (run_dir / "processing_times.csv").exists()


def test_runner_run_id_needs_mlflow(tmp_path, monkeypatch):
    from yolo_sam_inference_tpu_torch.apps import single_batch_inference as tapp

    monkeypatch.setitem(sys.modules, "mlflow", None)  # absent, wherever it is installed
    (tmp_path / "in").mkdir()
    with pytest.raises(RuntimeError, match="mlflow"):
        tapp.main(["--input-dir", str(tmp_path / "in"), "--output-dir", str(tmp_path / "o"),
                   "--device", "cpu", "--run-id", "abc"])


# -------------------------------------------------------------- root API


def test_root_api_resolves_without_jax():
    """``import yolo_sam_inference_tpu_torch`` and each public name of the
    JAX package's root resolve with neither jax nor the JAX package loaded."""
    import yolo_sam_inference_tpu as jroot

    code = (
        "import sys\n"
        "import yolo_sam_inference_tpu_torch as p\n"
        "names = sys.argv[1].split(',')\n"
        "missing = [n for n in names if getattr(p, n, None) is None]\n"
        "loaded = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "          or m.split('.')[0] == 'yolo_sam_inference_tpu']\n"
        "assert not missing and not loaded, (missing, loaded)\n"
        "print('ok', len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, ",".join(jroot.__all__)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == f"ok {len(jroot.__all__)}"


def test_mask_encoding_matches_jax():
    mask = np.random.default_rng(4).random((37, 53)) > 0.6
    enc = tmask_encoding.encode_binary_mask(mask)
    assert enc == jmask_encoding.encode_binary_mask(mask)
    np.testing.assert_array_equal(tmask_encoding.decode_binary_mask(enc), mask)
    np.testing.assert_array_equal(jmask_encoding.decode_binary_mask(enc), mask)


def test_bridge_makes_converted_mobilesam_weights_contiguous():
    """A converted TinyViT's folded convs are transposed views; the bridge
    hands the kernels contiguous weights."""
    tcfg = TinyViTConfig(image_size=64, output_channels=16)
    cfg = dataclasses.replace(sam_tiny_test(), image_size=64, patch_size=16)
    tree = tconvert.convert_mobilesam_state_dict(
        checkpoints.mobilesam_state_dict(tcfg, cfg, 6, with_bias_idxs=False), cfg, tcfg)
    assert not tree["tinyvit"]["stage0"][0]["conv1"]["w"].flags.c_contiguous
    _, sam = from_jax_params(None, tree, "cpu", torch.bfloat16, sam_config=cfg)
    assert all(p.is_contiguous() for p in sam.parameters())
