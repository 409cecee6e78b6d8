"""YOLOv8 static configuration and channel arithmetic."""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    """Static YOLOv8 hyperparameters (v8 detect family)."""

    depth_mult: float = 1 / 3
    width_mult: float = 0.25
    max_channels: int = 1024
    num_classes: int = 1  # the reference's cell detector is single-class
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    image_size: int = 640

    def ch(self, base: int) -> int:
        return _make_divisible(min(base, self.max_channels) * self.width_mult)

    def depth(self, base: int) -> int:
        return max(round(base * self.depth_mult), 1)

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        """(P1..P5) channels after each downsampling conv."""
        return tuple(self.ch(c) for c in (64, 128, 256, 512, 1024))

    @property
    def detect_channels(self) -> Tuple[int, ...]:
        """Input channels of the three detect levels (P3, P4, P5)."""
        c = self.stage_channels
        return (c[2], c[3], c[4])

    @property
    def box_branch_ch(self) -> int:
        return max(16, self.detect_channels[0] // 4, self.reg_max * 4)

    @property
    def cls_branch_ch(self) -> int:
        return max(self.detect_channels[0], min(self.num_classes, 100))


def yolov8n(num_classes: int = 1) -> YoloConfig:
    return YoloConfig(depth_mult=1 / 3, width_mult=0.25, num_classes=num_classes)


def yolov8s(num_classes: int = 1) -> YoloConfig:
    return YoloConfig(depth_mult=1 / 3, width_mult=0.5, num_classes=num_classes)


def yolov8m(num_classes: int = 1) -> YoloConfig:
    return YoloConfig(
        depth_mult=2 / 3, width_mult=0.75, max_channels=768, num_classes=num_classes
    )
