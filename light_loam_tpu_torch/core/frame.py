"""Containers for point clouds and per-frame feature sets.

Counterpart of ``light_loam_tpu/core/frame.py``.  Every container is a
fixed-capacity padded tensor plus a validity mask, so shapes never depend
on the data and nothing waits on the device to size a buffer.  The
reference's ``intensity = scanID + scanPeriod * relTime`` channel
(src/scanRegistration.cpp:208) is carried as ``rel``; the ring id is
``floor(rel)`` (src/laserOdometry.cpp:500).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PointCloud(NamedTuple):
    """Fixed-capacity padded point cloud."""

    xyz: torch.Tensor   # (N, 3) float32
    rel: torch.Tensor   # (N,)  float32: ring + scan_period * rel_time
    mask: torch.Tensor  # (N,)  bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask.to(torch.int32), dim=-1)

    def ring(self) -> torch.Tensor:
        """Integer ring id, mirroring ``int(intensity)``."""
        return torch.floor(self.rel).to(torch.int32)

    @staticmethod
    def zeros(capacity: int, device=None, dtype=torch.float32) -> "PointCloud":
        return PointCloud(
            xyz=torch.zeros((capacity, 3), dtype=dtype, device=device),
            rel=torch.zeros((capacity,), dtype=dtype, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


class RangeImage(NamedTuple):
    """Ring-organized scan: (n_scans, h_max) grid in within-ring order
    (src/scanRegistration.cpp:216-221); ``counts`` are the per-ring
    extents."""

    xyz: torch.Tensor     # (R, H, 3) float32
    rel: torch.Tensor     # (R, H) float32
    mask: torch.Tensor    # (R, H) bool
    counts: torch.Tensor  # (R,) int32 valid points per ring

    def flatten(self) -> PointCloud:
        R, H, _ = self.xyz.shape
        return PointCloud(
            xyz=self.xyz.reshape(R * H, 3),
            rel=self.rel.reshape(R * H),
            mask=self.mask.reshape(R * H),
        )


class ScanFeatures(NamedTuple):
    """The five clouds the feature stage publishes
    (src/scanRegistration.cpp:382-410)."""

    full: RangeImage        # /velodyne_cloud_2
    sharp: PointCloud       # /laser_cloud_sharp        (label 2)
    less_sharp: PointCloud  # /laser_cloud_less_sharp   (label >= 1)
    flat: PointCloud        # /laser_cloud_flat         (label -1)
    less_flat: PointCloud   # /laser_cloud_less_flat    (label <= 0, voxelized)
