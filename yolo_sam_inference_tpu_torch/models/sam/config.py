"""SAM configuration (static hyperparameters; everything shape-relevant).

A configuration's class is its SAM family (the ViT, MobileSAM, SAM 2) and
answers what the engine asks of one: its tree, the stage's configuration for
a frame shape, the model, and what it refuses to run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .tinyvit import TinyViTConfig, init_tinyvit_params, is_tinyvit


@dataclasses.dataclass(frozen=True)
class SamTPUConfig:
    """Static SAM hyperparameters (one config object for all three stages)."""

    # vision encoder (ViTDet-style)
    image_size: int = 1024
    patch_size: int = 16
    vision_hidden: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp_dim: int = 3072
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    output_channels: int = 256  # neck output / decoder input
    use_rel_pos: bool = True
    # prompt encoder / decoder
    prompt_hidden: int = 256
    num_pos_feats: int = 128
    mask_input_channels: int = 16
    decoder_layers: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    iou_head_hidden: int = 256
    iou_head_depth: int = 3
    num_multimask_outputs: int = 3
    layer_norm_eps: float = 1e-6
    decoder_layer_norm_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size  # 64 for standard SAM

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1

    @property
    def low_res_size(self) -> int:
        return self.grid_size * 4  # 256 for standard SAM

    def sized(self, cfg=None):
        """This family at ``cfg``'s sizes (a ViT name takes ``cfg`` as given)."""
        return self if cfg is None else cfg

    def params(self, seed: int, checkpoint=None):
        """The tree from ``checkpoint``, else drawn from a pipeline's seed (the
        JAX engine's SAM sub-seed, 2 seed + 1)."""
        from .convert import load_sam_params
        from .model import init_sam_params

        if checkpoint is not None:
            return load_sam_params(checkpoint, self)
        return init_sam_params(2 * seed + 1, self)

    def refuse(self, tree=None, *, encoder_parallel: str = "none", **_) -> None:
        """A TinyViT tree (MobileSAM) has no sequence- or tensor-parallel encoder."""
        if encoder_parallel != "none" and tree is not None and is_tinyvit(tree):
            raise ValueError("encoder_parallel supports ViT SAM encoders only (TinyViT's conv "
                             "stages have no tp/sp sharding)")

    def for_frame(self, h: int, w: int, size: Optional[int] = None) -> "SamTPUConfig":
        """The stage's configuration for (h, w) frames: the canvas ``size``, else
        native resolution (the smallest of 256 / 512 / 768 / 1024 that holds
        the frame), in windows of 16 where 16 divides the grid (every grid of
        that ladder)."""
        if size is None:
            size = next((s for s in (256, 512, 768, 1024) if max(h, w) <= s), 1024)
        ws = 16 if (size // self.patch_size) % 16 == 0 else self.window_size
        return dataclasses.replace(self, image_size=size, window_size=ws)

    def adapt_params(self, tree, cfg: "SamTPUConfig"):
        """``tree`` for the stage's ``cfg``: the ViT's position tables resized
        to its grid and window. TinyViT's weights do not depend on the canvas."""
        from .convert import adapt_resolution

        if (cfg.image_size, cfg.window_size) == (self.image_size, self.window_size) \
                or is_tinyvit(tree):
            return tree
        return adapt_resolution(tree, cfg)

    def build(self, tree, conv2d_fused: bool = False, tinyvit_mbconv_compute: str = "fp32"):
        from .model import SamModel

        return SamModel(tree, self, conv2d_fused, tinyvit_mbconv_compute)


@dataclasses.dataclass(frozen=True)
class MobileSamConfig(SamTPUConfig):
    """MobileSAM: TinyViT-5M in the ViT encoder's place, with SAM ViT-B's
    prompt encoder and decoder. A seed draws SAM's tree, then TinyViT's from
    seed + 1 (the JAX engine's order), and drops the ViT encoder; a
    checkpoint must hold TinyViT."""

    def sized(self, cfg=None):
        return self if cfg is None else MobileSamConfig(**dataclasses.asdict(cfg))

    def params(self, seed: int, checkpoint=None):
        tree = super().params(seed, checkpoint)
        if "tinyvit" in tree:
            return tree
        if checkpoint is not None:
            raise ValueError(f"MobileSAM: {checkpoint} holds no TinyViT encoder "
                             "(image_encoder.* in MobileSAM naming)")
        tcfg = TinyViTConfig(image_size=self.image_size, output_channels=self.output_channels)
        tree = dict(tree, tinyvit=init_tinyvit_params(seed + 1, tcfg))
        tree.pop("vision", None)
        return tree


def mobile_sam(image_size: int = 1024) -> MobileSamConfig:
    return MobileSamConfig(image_size=image_size)


def sam_vit_b(image_size: int = 1024) -> SamTPUConfig:
    return SamTPUConfig(image_size=image_size)


def sam_vit_l(image_size: int = 1024) -> SamTPUConfig:
    return SamTPUConfig(
        image_size=image_size,
        vision_hidden=1024,
        vision_layers=24,
        vision_heads=16,
        vision_mlp_dim=4096,
        global_attn_indexes=(5, 11, 17, 23),
    )


def sam_vit_h(image_size: int = 1024) -> SamTPUConfig:
    return SamTPUConfig(
        image_size=image_size,
        vision_hidden=1280,
        vision_layers=32,
        vision_heads=16,
        vision_mlp_dim=5120,
        global_attn_indexes=(7, 15, 23, 31),
    )


def sam_tiny_test() -> SamTPUConfig:
    """Tiny config for parity tests against a random-init torch SamModel."""
    return SamTPUConfig(
        image_size=64,
        patch_size=8,
        vision_hidden=32,
        vision_layers=2,
        vision_heads=2,
        vision_mlp_dim=64,
        window_size=2,
        global_attn_indexes=(1,),
        output_channels=16,
        prompt_hidden=16,
        num_pos_feats=8,  # must equal prompt_hidden // 2
        mask_input_channels=4,
        decoder_layers=2,
        decoder_heads=2,
        decoder_mlp_dim=32,
        iou_head_hidden=16,
    )


@dataclasses.dataclass(frozen=True)
class Sam2Config:
    """SAM 2's image path: the Hiera trunk, its FPN neck and the mask decoder
    with high-resolution features (``sam2/configs/sam2.1/*.yaml``,
    ``sam2/modeling/backbones/hieradet.py``, ``image_encoder.py``,
    ``sam/mask_decoder.py``). The prompt encoder and the two-way transformer
    are SAM's, so the decoder's fields keep :class:`SamTPUConfig`'s names."""

    image_size: int = 1024
    # Hiera trunk: a 7x7 stride-4 patch embedding, then stages whose first
    # block (past the first stage) pools its queries 2x2 and doubles the width
    # and the heads
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    window_spec: Tuple[int, ...] = (8, 4, 16, 8)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    pos_embed_bkg: int = 7  # the side of the interpolated background position table
    patch_kernel: int = 7
    patch_stride: int = 4
    mlp_ratio: float = 4.0
    # FPN neck: nearest top-down sums at these levels, the coarsest ``scalp``
    # levels dropped; the decoder's high-resolution projections of levels 0, 1
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    scalp: int = 1
    output_channels: int = 256
    # prompt encoder / decoder (SAM's, with the object-score token first)
    prompt_hidden: int = 256
    num_pos_feats: int = 128
    decoder_layers: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    iou_head_hidden: int = 256
    iou_head_depth: int = 3
    num_multimask_outputs: int = 3
    layer_norm_eps: float = 1e-6
    decoder_layer_norm_eps: float = 1e-5  # SAM 2's decoder LayerNorms: nn.LayerNorm defaults
    # single-mask output: token 0 unless its stability (area above +delta
    # over area above -delta, over its whole low-res mask) is below thresh,
    # then the best of tokens 1.. by predicted IoU
    stability_delta: float = 0.05
    stability_thresh: float = 0.98

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        return tuple(sum(self.stages[:i + 1]) - 1 for i in range(len(self.stages)))

    @property
    def q_pool_blocks(self) -> Tuple[int, ...]:
        return tuple(e + 1 for e in self.stage_ends[:-1])

    def blocks(self):
        """Every trunk block as (dim, dim_out, heads, window, pools): a block
        takes the window of the stage it starts in (0: global), so a stage's
        first block, which pools, runs the previous stage's window."""
        out, dim, heads, stage = [], self.embed_dim, self.num_heads, 0
        for i in range(sum(self.stages)):
            window = 0 if i in self.global_att_blocks else self.window_spec[stage]
            dim_out = dim
            if i - 1 in self.stage_ends:
                dim_out, heads, stage = 2 * dim, 2 * heads, stage + 1
            out.append((dim, dim_out, heads, window, i in self.q_pool_blocks))
            dim = dim_out
        return out

    def attention(self):
        """Every trunk block's attention as (grid, heads, window, pools): the
        side of the token grid the block takes (its queries pool to half of
        it), then as :meth:`blocks`."""
        out, side = [], self.trunk_grid
        for _, _, heads, window, pool in self.blocks():
            out.append((side, heads, window, pool))
            side //= 2 if pool else 1
        return out

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.stages)))

    @property
    def trunk_grid(self) -> int:
        return self.image_size // self.patch_stride  # 256 at the 1024 canvas

    @property
    def grid_size(self) -> int:
        """The side of the image embedding the decoder attends to: the finest
        level the scalp keeps last."""
        return self.trunk_grid >> (len(self.stages) - 1 - self.scalp)

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1

    @property
    def low_res_size(self) -> int:
        return self.grid_size * 4

    def sized(self, cfg=None):
        return self if cfg is None else cfg

    def params(self, seed: int, checkpoint=None):
        """Drawn from a pipeline's seed at 2 seed + 1 (checkpoints are refused)."""
        from .hiera import init_sam2_params

        return init_sam2_params(2 * seed + 1, self)

    def refuse(self, tree=None, *, quant: str = "none", encoder_parallel: str = "none",
               checkpoint=None) -> None:
        if quant != "none" or encoder_parallel != "none":
            raise ValueError("SAM 2 runs in compute_dtype on one card: quant='none', "
                             "encoder_parallel='none'")
        if checkpoint is not None:
            raise ValueError("SAM 2 checkpoints have no converter yet: pass params= or draw "
                             "random weights")

    def for_frame(self, h: int, w: int, size: Optional[int] = None) -> "Sam2Config":
        """The encoder at ``size``, else at this configuration's canvas."""
        if h != w:
            raise ValueError(f"SAM 2 takes square frames here, got {h}x{w}: its transforms "
                             "resize to a square canvas, which the crop geometry does not yet "
                             "follow on other frames")
        return dataclasses.replace(self, image_size=size or self.image_size)

    def adapt_params(self, tree, cfg: "Sam2Config"):
        return tree

    def build(self, tree, **_):
        from .hiera import Sam2Model

        return Sam2Model(tree, self)


def sam2_1_hiera_l(image_size: int = 1024) -> Sam2Config:
    """SAM 2.1 Hiera-L (``sam2.1_hiera_l.yaml``; ``facebook/sam2.1-hiera-large``)."""
    return Sam2Config(image_size=image_size)


def sam2_tiny_test() -> Sam2Config:
    """Tiny SAM 2 for the CPU tests: every stage transition, two blocks in
    stage 3 (the second global), head dim 8, a 64-pixel canvas (trunk grid
    16, embedding grid 4)."""
    return Sam2Config(
        image_size=64, embed_dim=16, num_heads=2, stages=(1, 2, 2, 1), window_spec=(4, 2, 2, 2),
        global_att_blocks=(4,), pos_embed_bkg=3, output_channels=32, prompt_hidden=32,
        num_pos_feats=16, decoder_heads=2, decoder_mlp_dim=32, iou_head_hidden=16)
