"""Precision, rotations and the pieces every stage of the plain reference
shares.

The reference runs in float64 (``Numerics``); every product of two arrays
goes through ``Numerics.mm``, so that the control, the reference in TF32,
changes each of them.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Numerics:
    """The dtype of the reference and how it forms matrix products: float64,
    or for the control float32 with every matrix product in TF32 (on a card
    its tensor cores; on a CPU both operands rounded to TF32 first)."""

    def __init__(self, tf32: bool = False, dtype=None):
        self.tf32 = tf32
        self.dtype = dtype or (torch.float32 if tf32 else torch.float64)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched where the operands are)."""
        if self.tf32 and not a.is_cuda:
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)

    def sqdist(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(n, m) squared distances in Gram form, |a|² + |b|² - 2 a·b."""
        return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
                - 2.0 * self.mm(a, b.T))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, xyzw."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (3,) -> unit quaternion."""
    th = torch.linalg.norm(v)
    if float(th) < 1e-12:
        return quat_normalize(torch.cat([v / 2, v.new_ones(1)]))
    s = torch.sin(th / 2) / th
    return torch.cat([v * s, torch.cos(th / 2)[None]])


def rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (xyzw) -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def skew(v: torch.Tensor) -> torch.Tensor:
    """(n, 3) -> (n, 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[:, 0])
    return torch.stack([
        torch.stack([z, -v[:, 2], v[:, 1]], -1),
        torch.stack([v[:, 2], z, -v[:, 0]], -1),
        torch.stack([-v[:, 1], v[:, 0], z], -1),
    ], dim=-2)


def transform(nm: Numerics, q: torch.Tensor, t: torch.Tensor,
              p: torch.Tensor) -> torch.Tensor:
    """R(q) p + t for (n, 3) points."""
    return nm.mm(p, rot(q).T) + t


def voxel_order(xyz: torch.Tensor, leaf: float, major=None):
    """Integer voxel coordinates of each point and the lexicographic order
    of (major, z, x, y): the order in which a voxel grid anchored at the
    origin lists its voxels."""
    ijk = torch.floor(xyz / leaf).to(torch.int64)
    cols = [ijk[:, 1], ijk[:, 0], ijk[:, 2]]
    if major is not None:
        cols.append(major.to(torch.int64))
    order = torch.arange(xyz.shape[0], device=xyz.device)
    for c in cols:   # least significant first, each sort stable
        order = order[torch.sort(c[order], stable=True)[1]]
    keys = torch.stack([c[order] for c in reversed(cols)], dim=-1)
    return order, keys


def voxel_centroids(xyz: torch.Tensor, leaf: float, major=None):
    """Centroids of the occupied voxels of a cloud in voxel order, with
    each voxel's ``major`` value (or None)."""
    if xyz.shape[0] == 0:
        return xyz, (None if major is None else major[:0])
    order, keys = voxel_order(xyz, leaf, major)
    new = torch.ones(keys.shape[0], dtype=torch.bool, device=xyz.device)
    new[1:] = (keys[1:] != keys[:-1]).any(-1)
    seg = torch.cumsum(new.to(torch.int64), 0) - 1
    n = int(seg[-1]) + 1
    sums = torch.zeros((n, 3), dtype=xyz.dtype, device=xyz.device)
    sums.index_add_(0, seg, xyz[order])
    cnt = torch.zeros(n, dtype=xyz.dtype, device=xyz.device)
    cnt.index_add_(0, seg, torch.ones_like(seg, dtype=xyz.dtype))
    cent = sums / cnt[:, None]
    out_major = None if major is None else major[order][new]
    return cent, out_major
