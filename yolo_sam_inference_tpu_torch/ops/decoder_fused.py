"""The mask decoder's passes over the image-token stream (kernels K6, K7).

Counterpart of ``yolo_sam_inference_tpu/ops/decoder_fused.py``. Three CUDA
kernels (``csrc/decoder_keys.cu``) carry its two functions on the card:

* :func:`i2t_keys_update` (K7): one pass over the (N, T, C) keys by
  ``keys_stream_kernel``: the image-to-token attention of one decoder layer,
  its residual add and LayerNorm, the next token-to-image attention's k/v
  projections of the new keys, and that attention's softmax over the pass's
  128-token tile, stored as per-tile partials; ``t2i_combine_kernel`` joins
  the tiles of each prompt. T need not be a multiple of 128: the last tile is
  short. Any number of prompt tokens: above 8 the kernel walks them in
  groups (the source note says how). The kernel runs its four products on
  wgmma with the weights, in their (in, out) layout, streamed by TMA
  through a ring of slabs in shared memory (:func:`slab_schedule`).
* :func:`t2i_shared_attend` (K6): the same pass without the i2t part
  projects decoder layer 0's per-image keys once per image
  (:func:`kv_project`), and ``t2i_attend_kernel`` runs the token-to-image
  attention of every prompt of the image over them.

The source note in ``csrc/decoder_keys.cu`` says what bounds the kernels and
what their design does about it.

Layouts are the JAX package's: tokens (N, T, C), prompt-token projections
(N, tq, dh) head-major, weights (in, out). At decoder layer 0 the keys are
per image, (B, T, C), and ``k_share = K`` makes prompt n read image n // K.

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernels or raises. Each launch function counts its
launches in ``.launches``. Where autograd records a CUDA call, the two
functions go through ``ops/autograd.py`` (the kernels forward, the plain
version's autograd as backward); the launch functions alone raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check, kernels
from .autograd import refuse_grad, through_kernel, wants_grad
from .fused_ln import _check_bf16, _f32, _on_cpu, _ptr, layer_norm_plain

# The kernels' geometry: SAM's decoder at every encoder size and prompt
# count. The partials hold the next queries in groups of KERNEL_TQ_GROUP.
KERNEL_C, KERNEL_DH, KERNEL_HEADS, KERNEL_TQ_GROUP, KERNEL_ROWS = 256, 128, 8, 8, 128
_PART = 16 + 2  # a per-tile partial: o[16], max, sum
SLAB_BYTES = 16 * 1024  # a stage of keys_stream_kernel's weight ring


def slab_schedule(i2t: bool) -> list:
    """The weight slabs ``keys_stream_kernel`` takes, in order, through its
    ring: (weight, first row, rows), each slab those rows of the (in, out)
    weight with all its columns, 16 KB of bf16. With the i2t part: wq's 4
    slabs of 64 rows, wout's 4 of 32 (the rows of heads 2 s and 2 s + 1),
    then wk's and wv's slabs of 64 rows in turn; without it only the last 8."""
    kv = [(w, 64 * s, 64) for s in range(4) for w in ("wk", "wv")]
    if not i2t:
        return kv
    return [("wq", 64 * s, 64) for s in range(4)] + [("wout", 32 * s, 32) for s in range(4)] + kv


# ------------------------------------------------------------------ plain math


def kv_project_plain(keys, img_pe, wk, bk, wv, bv):
    """kp = (keys + pe) @ wk + bk, vp = keys @ wv + bv in fp32 (results in
    keys' dtype)."""
    dt = keys.dtype
    pe = img_pe.reshape(1, keys.shape[1], -1).to(dt)
    kp = ((keys + pe).float() @ wk.float() + bk.float()).to(dt)
    vp = (keys.float() @ wv.float() + bv.float()).to(dt)
    return kp, vp


def t2i_attend_plain(qp, kp, vp, heads: int, k_share: int = 1):
    """fp32 version of :func:`t2i_attend` (result in qp's dtype)."""
    n, tq, dh = qp.shape
    nsrc, t, _ = kp.shape
    hd = dh // heads
    qh = qp.float().reshape(nsrc, k_share, tq, heads, hd)
    kh = kp.float().reshape(nsrc, t, heads, hd)
    vh = vp.float().reshape(nsrc, t, heads, hd)
    p = torch.softmax(torch.einsum("bkqhc,bthc->bkhqt", qh, kh), dim=-1).to(qp.dtype)
    out = torch.einsum("bkhqt,bthc->bkqhc", p.float(), vh)
    return out.reshape(n, tq, dh).to(qp.dtype)


def i2t_keys_update_plain(keys_src, img_pe, kq, vq, wq, bq, wout, bout, ln_scale, ln_bias, *,
                          heads: int, k_share: int = 1, eps: float = 1e-6, t2i: dict):
    """What :func:`i2t_keys_update` computes, in fp32 (results in keys_src's
    dtype)."""
    dt = keys_src.dtype
    x = keys_src if k_share == 1 else keys_src.repeat_interleave(k_share, dim=0)
    n, t, _ = x.shape
    pe = img_pe.reshape(1, t, -1).to(dt)
    dh = wq.shape[1]
    hd = dh // heads
    tq = kq.shape[1]
    qp = (((x + pe).float() @ wq.float() + bq.float()) * hd ** -0.5).to(dt)
    logits = torch.einsum("nthc,nqhc->nhtq", qp.float().reshape(n, t, heads, hd),
                          kq.float().reshape(n, tq, heads, hd))
    p = torch.softmax(logits, dim=-1).to(dt)
    attn = torch.einsum("nhtq,nqhc->nthc", p.float(), vq.float().reshape(n, tq, heads, hd))
    attn = attn.reshape(n, t, dh).to(dt)
    y = x.float() + (attn.float() @ wout.float() + bout.float())
    keys = layer_norm_plain(y, ln_scale, ln_bias, eps).to(dt)
    kp, vp = kv_project_plain(keys, img_pe, t2i["wk"], t2i["bk"], t2i["wv"], t2i["bv"])
    return keys, t2i_attend_plain(t2i["qp"], kp, vp, heads)


# ------------------------------------------------------------------ kernels


def _check_geometry(name: str, c: int, dh: int, heads: int) -> None:
    if (c, dh, heads) != (KERNEL_C, KERNEL_DH, KERNEL_HEADS):
        raise ValueError(f"{name} kernel takes C={KERNEL_C}, dh={KERNEL_DH}, {KERNEL_HEADS} "
                         f"heads; got C={c}, dh={dh}, heads={heads}")


def _check_tokens(name: str, tq: int) -> None:
    if tq < 1:
        raise ValueError(f"{name} kernel takes at least 1 prompt token, got {tq}")


def part_slots(tq2: int) -> int:
    """Query slots a head in the per-tile partials: tq2 rounded up to a
    whole group of KERNEL_TQ_GROUP."""
    return -(-tq2 // KERNEL_TQ_GROUP) * KERNEL_TQ_GROUP


def _weight(w, shape, dev):
    """The (in, out) bf16 weight, as the kernel's TMA reads it."""
    _check_bf16("weight", w, shape, dev)
    return w


def keys_stream(keys_src, img_pe, wk, bk, wv, bv, *, k_share: int = 1, i2t=None,
                qn: Optional[torch.Tensor] = None, eps: float = 1e-6):
    """Launch ``keys_stream_kernel`` on CUDA tensors (bf16, C = 256, dh = 128,
    8 heads, any T). Without ``i2t`` it returns (kp, vp); with
    ``i2t`` = (kq, vq, wq, bq, wout, bout, ln_scale, ln_bias) and the next
    queries ``qn`` (N, tq2, dh) already scaled, it returns (keys, partials)
    for :func:`t2i_combine`. :func:`kv_project_plain` and
    :func:`i2t_keys_update_plain` are its plain versions."""
    if _on_cpu(keys_src):
        raise ValueError("keys_stream launches the CUDA kernel; kv_project and "
                         "i2t_keys_update take the plain versions on the CPU")
    refuse_grad("keys_stream", keys_src, img_pe, wk, bk, wv, bv, qn, *(i2t or ()))
    nsrc, t, c = keys_src.shape
    n = nsrc * k_share
    dh = wk.shape[1]
    _check_geometry("keys_stream", c, dh, KERNEL_HEADS)
    dev = keys_src.device
    pe = img_pe.reshape(t, c)
    _check_bf16("keys_src", keys_src, (nsrc, t, c), dev)
    _check_bf16("img_pe", pe, (t, c), dev)
    outs = dict.fromkeys(("keys", "kp", "vp", "part"))
    i2t_args = [None] * 8
    tq = tq2 = 0
    if i2t is None:
        outs["kp"] = torch.empty((n, t, dh), dtype=torch.bfloat16, device=dev)
        outs["vp"] = torch.empty_like(outs["kp"])
    else:
        kq, vq, wq, bq, wout, bout, ln_s, ln_b = i2t
        tq, tq2 = kq.shape[1], qn.shape[1]
        _check_tokens("keys_stream", tq)
        _check_tokens("keys_stream", tq2)
        for name, v, m in (("kq", kq, tq), ("vq", vq, tq), ("qn", qn, tq2)):
            _check_bf16(name, v, (n, m, dh), dev)
        i2t_args = [kq, vq, _weight(wq, (c, dh), dev), _f32(bq), _weight(wout, (dh, c), dev),
                    _f32(bout), _f32(ln_s), _f32(ln_b)]
        outs["keys"] = torch.empty((n, t, c), dtype=torch.bfloat16, device=dev)
        outs["part"] = torch.empty(
            (n, -(-t // KERNEL_ROWS), KERNEL_HEADS * part_slots(tq2) * _PART),
            dtype=torch.float32, device=dev)
    err = kernels().ysi_keys_stream(
        _ptr(keys_src), _ptr(pe), *map(_ptr, i2t_args),
        _ptr(_weight(wk, (c, dh), dev)), _ptr(_f32(bk)), _ptr(_weight(wv, (c, dh), dev)),
        _ptr(_f32(bv)), _ptr(qn), *(_ptr(outs[k]) for k in ("keys", "kp", "vp", "part")),
        n, t, tq, tq2, k_share, (dh // KERNEL_HEADS) ** -0.5, float(eps), int(i2t is not None),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "keys_stream")
    keys_stream.launches += 1
    return (outs["kp"], outs["vp"]) if i2t is None else (outs["keys"], outs["part"])


keys_stream.launches = 0


def t2i_tile_partials_plain(qn, kp, vp) -> torch.Tensor:
    """The per-tile partials :func:`keys_stream` stores for the next
    attention, in fp32: qn (N, tq2, dh) already scaled, kp and vp (N, T, dh)
    -> (N, ceil(T / 128), heads * slots * (16 + 2)), slots =
    :func:`part_slots` (tq2). Per 128-token tile, head and query: o = sum e
    vp, the max m and l = sum e, with e = exp(qn . kp - m) over the tile's
    tokens below T (the last tile may be short). The slots past tq2 hold
    zeros (the kernel leaves them unwritten)."""
    n, tq2, dh = qn.shape
    t = kp.shape[1]
    heads, hd = KERNEL_HEADS, dh // KERNEL_HEADS
    tiles = -(-t // KERNEL_ROWS)
    part = torch.zeros((n, tiles, heads, part_slots(tq2), hd + 2), device=qn.device)
    q = qn.float().reshape(n, tq2, heads, hd)
    for i in range(tiles):
        sl = slice(i * KERNEL_ROWS, min(t, (i + 1) * KERNEL_ROWS))
        k = kp[:, sl].float().reshape(n, -1, heads, hd)
        v = vp[:, sl].float().reshape(n, -1, heads, hd)
        s = torch.einsum("nqhd,nrhd->nhqr", q, k)
        m = s.amax(-1)
        e = torch.exp(s - m[..., None])
        part[:, i, :, :tq2, :hd] = torch.einsum("nhqr,nrhd->nhqd", e, v)
        part[:, i, :, :tq2, hd] = m
        part[:, i, :, :tq2, hd + 1] = e.sum(-1)
    return part.reshape(n, tiles, -1)


def t2i_combine_plain(part: torch.Tensor, tq2: int) -> torch.Tensor:
    """The per-tile partials of :func:`keys_stream` (N, tiles, heads *
    :func:`part_slots` (tq2) * (16 + 2)): o, max, sum per (head, query) ->
    (N, tq2, dh) bf16."""
    n, tiles, _ = part.shape
    p = part.float().reshape(n, tiles, KERNEL_HEADS, part_slots(tq2), _PART)[:, :, :, :tq2]
    m = p[..., 16]
    w = torch.exp(m - m.amax(dim=1, keepdim=True))  # rescale each tile to the global max
    out = (p[..., :16] * w[..., None]).sum(1) / (p[..., 17] * w).sum(1)[..., None]
    return out.permute(0, 2, 1, 3).reshape(n, tq2, KERNEL_DH).to(torch.bfloat16)


def _check_partials(part: torch.Tensor, tq2: int) -> None:
    """The partials must be laid out for tq2 next queries: the kernel reads
    them by that layout and would run past a smaller buffer."""
    if part.dtype != torch.float32 or not part.is_contiguous() or part.dim() != 3:
        raise ValueError(f"t2i_combine: needs contiguous fp32 partials (N, tiles, values), got "
                         f"{part.dtype} {tuple(part.shape)} contiguous={part.is_contiguous()}")
    want = KERNEL_HEADS * part_slots(tq2) * _PART
    if part.shape[2] != want:
        raise ValueError(f"t2i_combine: partials hold {part.shape[2]} values a tile; tq2 {tq2} "
                         f"takes {want} ({KERNEL_HEADS} heads x {part_slots(tq2)} slots x {_PART})")


def t2i_combine(part: torch.Tensor, tq2: int) -> torch.Tensor:
    """The next attention's output (N, tq2, dh) bf16 from the per-tile
    partials of :func:`keys_stream`; CUDA tensors launch
    ``t2i_combine_kernel``, see :func:`t2i_combine_plain`."""
    _check_tokens("t2i_combine", tq2)
    _check_partials(part, tq2)
    if _on_cpu(part):
        return t2i_combine_plain(part, tq2)
    refuse_grad("t2i_combine", part)
    n, tiles, _ = part.shape
    out = torch.empty((n, tq2, KERNEL_DH), dtype=torch.bfloat16, device=part.device)
    err = kernels().ysi_t2i_combine(_ptr(part), _ptr(out), n, tiles, tq2,
                                    torch.cuda.current_stream(part.device).cuda_stream)
    check(err, "t2i_combine")
    t2i_combine.launches += 1
    return out


t2i_combine.launches = 0


def t2i_attend(qp, kp, vp, heads: int, k_share: int = 1):
    """Token-to-image attention: qp (N, tq, dh) already scaled, kp/vp
    (N / k_share, T, dh) -> (N, tq, dh), head-major. CUDA tensors launch
    ``t2i_attend_kernel`` (bf16, dh = 128, 8 heads, any tq)."""
    if _on_cpu(qp):
        return t2i_attend_plain(qp, kp, vp, heads, k_share)
    refuse_grad("t2i_attend", qp, kp, vp)
    n, tq, dh = qp.shape
    nsrc, t, _ = kp.shape
    _check_geometry("t2i_attend", KERNEL_C, dh, heads)
    _check_tokens("t2i_attend", tq)
    if nsrc * k_share != n:
        raise ValueError(f"t2i_attend: {n} prompts != {nsrc} sources x k_share {k_share}")
    dev = qp.device
    _check_bf16("qp", qp, (n, tq, dh), dev)
    _check_bf16("kp", kp, (nsrc, t, dh), dev)
    _check_bf16("vp", vp, (nsrc, t, dh), dev)
    out = torch.empty_like(qp)
    err = kernels().ysi_t2i_attend(_ptr(qp), _ptr(kp), _ptr(vp), _ptr(out), n, tq, t, k_share,
                                   torch.cuda.current_stream(dev).cuda_stream)
    check(err, "t2i_attend")
    t2i_attend.launches += 1
    return out


t2i_attend.launches = 0


# ------------------------------------------------------------ the decoder's passes


def kv_project(keys, img_pe, wk, bk, wv, bv, heads: int):
    """(kp, vp) of the token-to-image attention from (N, T, C) keys: one
    ``keys_stream`` pass on CUDA tensors, :func:`kv_project_plain` on CPU."""
    if _on_cpu(keys):
        return kv_project_plain(keys, img_pe, wk, bk, wv, bv)
    if heads != KERNEL_HEADS:
        raise ValueError(f"keys_stream kernel takes {KERNEL_HEADS} heads, got {heads}")
    return keys_stream(keys, img_pe, wk, bk, wv, bv)


def t2i_shared_attend_plain(keys_img, img_pe, qp, wk, bk, wv, bv, heads: int, k_share: int):
    """What :func:`t2i_shared_attend` computes, in fp32 (result in qp's dtype)."""
    kp, vp = kv_project_plain(keys_img, img_pe, wk, bk, wv, bv)
    return t2i_attend_plain(qp, kp, vp, heads, k_share)


def t2i_shared_attend(keys_img, img_pe, qp, wk, bk, wv, bv, heads: int, k_share: int):
    """Decoder layer-0 token-to-image attention against per-image keys (K6):
    the k/v projections run once per image, keys_img (B, T, C); qp
    (B * k_share, tq, dh) already scaled. Returns (N, tq, dh)."""
    if not _on_cpu(keys_img) and wants_grad(keys_img, img_pe, qp, wk, bk, wv, bv):
        return through_kernel(t2i_shared_attend, t2i_shared_attend_plain, keys_img, img_pe, qp,
                              wk, bk, wv, bv, heads, k_share)
    kp, vp = kv_project(keys_img, img_pe, wk, bk, wv, bv, heads)
    return t2i_attend(qp, kp, vp, heads, k_share)


def i2t_keys_update(keys_src, img_pe, kq, vq, wq, bq, wout, bout, ln_scale, ln_bias, *,
                    heads: int, k_share: int = 1, eps: float = 1e-6, t2i: dict):
    """One i2t + residual + LayerNorm pass over the keys stream (K7), with the
    next stage's token-to-image attention: ``t2i`` = {"qp": (N, tq2, dh)
    already scaled, "wk", "bk", "wv", "bv"}. Returns (keys (N, T, C),
    t2i_attn (N, tq2, dh)). On CUDA: one ``keys_stream`` pass and one
    ``t2i_combine``."""
    if _on_cpu(keys_src):
        return i2t_keys_update_plain(keys_src, img_pe, kq, vq, wq, bq, wout, bout, ln_scale,
                                     ln_bias, heads=heads, k_share=k_share, eps=eps, t2i=t2i)
    if wants_grad(keys_src, img_pe, kq, vq, wq, bq, wout, bout, ln_scale, ln_bias,
                  *t2i.values()):
        return through_kernel(i2t_keys_update, i2t_keys_update_plain, keys_src, img_pe, kq, vq,
                              wq, bq, wout, bout, ln_scale, ln_bias, heads=heads,
                              k_share=k_share, eps=eps, t2i=t2i)
    if heads != KERNEL_HEADS:
        raise ValueError(f"keys_stream kernel takes {KERNEL_HEADS} heads, got {heads}")
    keys, part = keys_stream(keys_src, img_pe, t2i["wk"], t2i["bk"], t2i["wv"], t2i["bv"],
                             k_share=k_share, qn=t2i["qp"], eps=eps,
                             i2t=(kq, vq, wq, bq, wout, bout, ln_scale, ln_bias))
    return keys, t2i_combine(part, t2i["qp"].shape[1])


__all__ = [
    "i2t_keys_update", "i2t_keys_update_plain", "keys_stream", "kv_project", "kv_project_plain",
    "part_slots", "slab_schedule", "t2i_attend", "t2i_attend_plain", "t2i_combine",
    "t2i_combine_plain", "t2i_shared_attend", "t2i_shared_attend_plain", "t2i_tile_partials_plain",
]
