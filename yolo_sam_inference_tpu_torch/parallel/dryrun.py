"""Multi-rank dry run of the port: the five parts of the JAX package's
``__graft_entry__.dryrun_multichip`` (``:52``) on ranks of this host.

    from yolo_sam_inference_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4)  # or dryrun_multichip(4, device="cpu")

``dryrun_multichip(n)`` starts ``n`` ranks (``parallel/launch.py``: NCCL
with a card each, else gloo, the ranks sharing the cards); each runs, on a
(dp = n / tp, tp = 2) mesh where n is even:

1. the engine under ``mesh=`` (data parallel; the tp axis repeats the work)
   against the single-rank engine on the same frames;
2. the tensor-parallel encoder (``parallel/tp.py``) on the rank's dp share,
   and the engine with ``encoder_parallel="tp"`` on the mesh (dp x tp),
   against the single-rank encoder and engine;
3. the sequence-parallel encoder on a (dp = n / 2, sp = 2) mesh, and the
   engine with ``encoder_parallel="sp"`` on it (dp x sp), the same way;
4. the pipeline-parallel encoder (``parallel/pp.py``) on ranks 0-1, 4
   microbatches, against the single-rank encoder;
5. two dp x tp fine-tune steps (``parallel/train.py``, learning rate 1e-5):
   a finite loss that falls.

On the card (the default) the model is SAM ViT-B's widths cut to 2 layers
(window 16, grid 32, one global layer) on 512 x 512 frames in bf16, as the
JAX dry run's flagship-shaped part; the encoders are held within 2% relative
RMS of the single-rank bf16 encoder, and the engines (dp included: a rank's
share runs YOLO and the kernels at another batch) to the detections exactly,
the boxes and scores within 1e-5 relative, the masks on 99% of pixels and
metrics within 2% relative RMS.
``device="cpu"`` runs the JAX dry run's tiny config in fp32 (the kernels do
not take its widths), held within 2e-4 (the engines 1e-4). No CPU path
stands in for the card: ``device="cuda"`` without one raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


def _setup(device: str, dp: int):
    """(sam config, engine options, frames) of the run."""
    from ..models.sam import SamTPUConfig, sam_tiny_test
    from ..pipeline.engine import PipelineOptions

    rng = np.random.default_rng(0)
    if device == "cpu":
        cfg = sam_tiny_test()
        opts = PipelineOptions(batch_size=2 * dp, max_det=8, metric_crop=48, yolo_size=64,
                               nms_candidates=64, compute_dtype=torch.float32,
                               sam_encoder_size=64)
        frames = rng.integers(0, 255, size=(2 * dp, 96, 128, 3), dtype=np.uint8)
        return cfg, opts, frames
    from ..bench.common import cell_frames

    cfg = SamTPUConfig(image_size=512, vision_layers=2, window_size=16, global_attn_indexes=(1,))
    opts = PipelineOptions(batch_size=2 * dp, max_det=8, metric_crop=128, sam_encoder_size=512)
    return cfg, opts, cell_frames(rng, 2 * dp, 512)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp(min=1e-30)).item()


def _embeddings_close(tag: str, got, want, device: str) -> None:
    if device == "cpu":
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=tag)
        return
    rel = _rel(got, want)
    if not (rel <= 0.02 and torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: relative RMS {rel:.3e} against the single rank (bound 0.02)")


def _outputs_close(tag: str, got: dict, want: dict, device: str) -> None:
    """The engine's outputs against the single rank's (see the module note:
    on the card a rank's share runs the kernels at another batch, so a few
    mask pixels may fall the other way)."""
    from ..ops.metrics import METRIC_KEYS

    if device == "cpu":
        tol = dict(rtol=1e-4, atol=1e-4)
        for key in ("boxes", "scores", "valid", "mask_crops"):
            np.testing.assert_allclose(got[key], want[key], err_msg=f"{tag} {key}", **tol)
        for key in METRIC_KEYS:
            np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                       err_msg=f"{tag} {key}", **tol)
        return
    np.testing.assert_array_equal(got["valid"], want["valid"], err_msg=f"{tag} valid")
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-4,
                                   err_msg=f"{tag} {key}")
    valid = want["valid"]
    agree = (got["mask_crops"][valid] == want["mask_crops"][valid]).mean()
    if agree < 0.99:
        raise AssertionError(f"{tag}: masks agree on {agree:.4f} of the valid cells' pixels")
    for key in METRIC_KEYS:
        g, w = got["metrics"][key][valid], want["metrics"][key][valid]
        rel = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        if rel > 0.02:
            raise AssertionError(f"{tag}: metric {key} relative RMS {rel:.3e} (bound 0.02)")


def _say(rank: int, msg: str) -> None:
    if rank == 0:
        print(f"dryrun_multichip {msg}", flush=True)


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    """One rank's five parts; returns the parts run and the two losses."""
    from ..models.sam import SamImageEncoder, init_sam_params
    from ..models.yolo import YoloConfig
    from ..pipeline.engine import CellSegmentationPipeline
    from .mesh import data_shard, make_mesh, make_mesh_axes
    from .pp import sam_image_encoder_pp, stage_tree
    from .sp import sam_image_encoder_sp
    from .tp import sam_image_encoder_tp, shard_sam_encoder_tp
    from .train import make_train_state, sam_decoder_train_step

    if device == "cpu":
        torch.set_num_threads(1)
    dev = torch.device(device)
    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = make_mesh(dp=dp, tp=tp)
    cfg, opts, frames = _setup(device, dp)
    sp = next(n for n in (2, 1) if world % n == 0 and _fits(cfg, n))
    sp_mesh = make_mesh_axes(dp=world // sp, sp=sp)
    pp_group = dist.new_group([0, 1]) if world >= 2 else None  # on every rank
    parts = []
    kw = dict(device=device, sam_config=cfg, yolo_config=YoloConfig(num_classes=1), seed=0)

    # 1: the engine, data parallel over 'dp' (the tp axis repeats the work)
    single = CellSegmentationPipeline(**kw, options=opts)
    want = single.process_batch_arrays(frames)
    got = CellSegmentationPipeline(**kw, options=opts, mesh=mesh).process_batch_arrays(frames)
    _outputs_close("dp engine", got, want, device)
    parts.append("dp engine")
    _say(rank, f"inference ok: the engine dp-sharded over {dp} ranks == the single rank "
               f"(batch {frames.shape[0]}, {int(want['valid'].sum())} detections)")

    tree = init_sam_params(1, cfg)
    pix_all = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4 * dp, cfg.image_size, cfg.image_size, 3)).astype(np.float32)).to(dev)
    pix_all = pix_all.to(opts.compute_dtype)
    enc = SamImageEncoder(tree["vision"], cfg).to(dev, opts.compute_dtype)
    with torch.inference_mode():
        ref = enc(pix_all)

        # 2: tp encoder on the rank's dp share; the engine's encoder_parallel="tp"
        if tp > 1:
            share = data_shard(mesh, pix_all.shape[0])
            shard = shard_sam_encoder_tp(tree, cfg, tp, mesh.index("tp"))
            tenc = SamImageEncoder(shard["vision"], cfg).to(dev, opts.compute_dtype)
            emb = sam_image_encoder_tp(tenc, pix_all[share], cfg, mesh.axis_group("tp"))
            _embeddings_close("tp encoder", emb, ref[share], device)
            parts.append("tp encoder")
            _say(rank, f"tp-encoder ok: heads/mlp sharded over tp={tp}, batch over dp={dp} == "
                       "the single rank")
    if tp > 1:
        tp_opts = dataclasses.replace(opts, encoder_parallel="tp")
        got = CellSegmentationPipeline(**kw, options=tp_opts, mesh=mesh).process_batch_arrays(
            frames)
        _outputs_close("dp x tp engine", got, want, device)
        parts.append("dp x tp engine")
        _say(rank, "encoder_parallel='tp' ok: the engine on the dp x tp mesh == the single rank")

    # 3: sp encoder on a (dp, sp) mesh; the engine's encoder_parallel="sp"
    if sp > 1:
        with torch.inference_mode():
            share = data_shard(sp_mesh, pix_all.shape[0])
            emb = sam_image_encoder_sp(enc, pix_all[share], cfg, sp_mesh.axis_group("sp"))
        _embeddings_close("sp encoder", emb, ref[share], device)
        sp_opts = dataclasses.replace(opts, encoder_parallel="sp")
        got = CellSegmentationPipeline(**kw, options=sp_opts, mesh=sp_mesh).process_batch_arrays(
            frames)
        _outputs_close("dp x sp engine", got, want, device)
        parts += ["sp encoder", "dp x sp engine"]
        _say(rank, f"sp-encoder ok: token rows over sp={sp}, batch over dp={world // sp} == the "
                   "single rank; encoder_parallel='sp' on the dp x sp mesh == the single rank")

    # 4: pp encoder, 2 stages on ranks 0-1, 4 microbatches
    if pp_group is not None and rank < 2:
        stage = SamImageEncoder(stage_tree(tree, cfg, 2, rank)["vision"], cfg).to(
            dev, opts.compute_dtype)
        with torch.inference_mode():
            emb = sam_image_encoder_pp(stage, pix_all[:4], cfg, pp_group, microbatches=4)
        _embeddings_close("pp encoder", emb, ref[:4], device)
        parts.append("pp encoder")
        _say(rank, "pp-encoder ok: 2 GPipe stages, 4 microbatches == the single rank")

    # 5: two dp x tp fine-tune steps
    rng = np.random.default_rng(0)
    b, k, low = 2 * dp, 2, cfg.low_res_size
    batch = {"images": rng.normal(size=(b, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
             "boxes": rng.uniform(0, cfg.image_size, size=(b, k, 4)).astype(np.float32),
             "masks": (rng.random((b, k, low, low)) > 0.5).astype(np.float32),
             "valid": np.ones((b, k), np.float32)}
    # JAX's dry run steps at 1e-4 and checks only a finite loss; Adam's first
    # steps move every weight by about the learning rate, which at ViT-B's
    # widths overshoots on random targets, so the falling loss is checked at 1e-5
    state = make_train_state(0, cfg, mesh, learning_rate=1e-5, device=device)
    state, loss1 = sam_decoder_train_step(state, batch, cfg)
    state, loss2 = sam_decoder_train_step(state, batch, cfg)
    if not (np.isfinite(loss1) and np.isfinite(loss2) and loss2 < loss1):
        raise AssertionError(f"train step: losses {loss1}, {loss2}: not finite and falling")
    _say(rank, f"ok: mesh=(dp={dp}, tp={tp}), loss={loss1:.4f} -> {loss2:.4f}")
    return {"parts": parts + ["train"], "losses": [loss1, loss2]}


def _fits(cfg, n: int) -> bool:
    """Whether ``n`` sequence-parallel ranks fit the grid and its windows."""
    from .sp import rows_per_rank

    try:
        rows_per_rank(cfg, n)
        return True
    except ValueError:
        return False


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The five parts on ``n_devices`` ranks (module note); a failed part
    raises here."""
    from .launch import run_ranks

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device")
    run_ranks(_dryrun_rank, n_devices, (device,))

