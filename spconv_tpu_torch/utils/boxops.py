"""Box utilities (counterpart of ``spconv_tpu/utils/boxops.py``): rotated
box intersection and IoU, axis-aligned NMS and rotated NMS.

Batched torch ops on the boxes' device: the rotated intersection clips
every ``[N, M]`` pair's polygon at once (Sutherland-Hodgman on a fixed
12-vertex buffer with a validity mask, the JAX package's arithmetic), and
the greedy keep walks the score-sorted IoU matrix one box at a time with
device ops only, so no value is read back to the host."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["rbbox_iou", "rbbox_intersection", "nms", "rotate_nms"]

_NV = 12  # polygon buffer: 4 corners, each of 4 clips can add one vertex


def _box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """``[N, 5]`` (cx, cy, w, h, angle) -> ``[N, 4, 2]`` corners (ccw)."""
    cx, cy, w, h, a = boxes.unbind(1)
    cos, sin = torch.cos(a), torch.sin(a)
    dx = torch.stack([w, w, -w, -w], 1) / 2
    dy = torch.stack([-h, h, h, -h], 1) / 2
    x = cx[:, None] + dx * cos[:, None] - dy * sin[:, None]
    y = cy[:, None] + dx * sin[:, None] + dy * cos[:, None]
    return torch.stack([x, y], -1)


def _next_valid(valid: torch.Tensor) -> torch.Tensor:
    """Per vertex, the index of the next one on a prefix-valid polygon
    (the last valid vertex wraps to 0), ``[B, n]`` int64."""
    n = valid.shape[1]
    idx = torch.arange(n, device=valid.device)
    cnt = valid.sum(1, keepdim=True)
    return torch.where(idx + 1 < cnt, idx + 1, torch.zeros_like(idx))


def _polygon_area(poly: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shoelace area of ``[B, n, 2]`` polygons whose valid vertices
    (``[B, n]``) form a prefix."""
    nxt = _next_valid(valid)
    x, y = poly[..., 0], poly[..., 1]
    cross = x * y.gather(1, nxt) - x.gather(1, nxt) * y
    return (cross * valid.to(poly.dtype)).sum(1).abs() / 2


def _clip_polygon(poly, valid, a, b):
    """Clip ``[B, n, 2]`` prefix-valid polygons by the half-plane left of
    ``a -> b`` (``[B, 2]`` each); returns ``n + 4`` vertices and their
    mask, the emitted vertices compacted in edge order."""
    n = poly.shape[1]
    idx = torch.arange(n, device=poly.device)
    cnt = valid.sum(1, keepdim=True)
    nxt = _next_valid(valid)
    d = b - a
    side = (d[:, 0:1] * (poly[..., 1] - a[:, 1:2])
            - d[:, 1:2] * (poly[..., 0] - a[:, 0:1]))
    inside = side >= 0
    side_n = side.gather(1, nxt)
    inside_n = inside.gather(1, nxt)
    denom = side - side_n
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    t = torch.where(denom.abs() > 1e-12, side / safe, torch.zeros_like(side))
    poly_n = poly.gather(1, nxt[..., None].expand(-1, -1, 2))
    inter = poly + t[..., None] * (poly_n - poly)

    # each edge (i, next) emits its start vertex if inside, then the
    # crossing point if it crosses
    emit1 = inside & valid
    emit2 = (inside != inside_n) & valid & (idx < cnt)
    verts = torch.cat([poly, inter], 1)
    emits = torch.cat([emit1, emit2], 1)
    order = torch.cat([idx * 2, idx * 2 + 1])
    rank = torch.where(emits, order, torch.full_like(order, 4 * n))
    perm = torch.sort(rank, dim=1, stable=True).indices
    out = verts.gather(1, perm[..., None].expand(-1, -1, 2))
    out_valid = emits.gather(1, perm)
    keep = torch.arange(n + 4, device=poly.device) < emits.sum(
        1, keepdim=True)
    return out[:, :n + 4], out_valid[:, :n + 4] & keep


def rbbox_intersection(boxes1: torch.Tensor,
                       boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area of rotated boxes ``[N, 5]`` x ``[M, 5]``
    -> ``[N, M]``: each box of ``boxes1`` clipped by the four edges of
    each box of ``boxes2``."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    c1 = _box_corners(boxes1)[:, None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    c2 = _box_corners(boxes2)[None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    poly = c1.new_zeros((n * m, _NV, 2))
    poly[:, :4] = c1
    valid = (torch.arange(_NV, device=c1.device) < 4).expand(n * m, _NV)
    for e in range(4):
        poly, valid = _clip_polygon(poly, valid, c2[:, e],
                                    c2[:, (e + 1) % 4])
        poly, valid = poly[:, :_NV], valid[:, :_NV]
    return _polygon_area(poly, valid).reshape(n, m)


def rbbox_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Rotated IoU ``[N, M]``."""
    inter = rbbox_intersection(boxes1, boxes2)
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    union = a1[:, None] + a2[None, :] - inter
    return inter / union.clamp(min=1e-12)


def _nms_from_iou(iou: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS on a pairwise IoU matrix: in descending score order (a
    stable sort), a valid box is kept unless a kept box before it overlaps
    it by more than ``thresh``.  Returns the keep mask in input order."""
    n = scores.shape[0]
    ninf = torch.full_like(scores, float("-inf"))
    order = torch.sort(-torch.where(valid, scores, ninf), stable=True).indices
    over = iou[order][:, order] > thresh
    valid_s = valid[order]
    keep_s = torch.zeros(n, dtype=torch.bool, device=scores.device)
    for i in range(n):
        # only boxes before i are kept so far
        keep_s[i] = valid_s[i] & ~(keep_s & over[:, i]).any()
    keep = torch.empty_like(keep_s)
    keep[order] = keep_s
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Axis-aligned NMS on ``[N, 4]`` (x1, y1, x2, y2) boxes; returns the
    keep mask."""
    if valid is None:
        valid = torch.ones(boxes.shape[0], dtype=torch.bool,
                           device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    iou = inter / (area[:, None] + area[None, :] - inter).clamp(min=1e-12)
    return _nms_from_iou(iou, scores, valid, thresh)


def rotate_nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotated NMS on ``[N, 5]`` (cx, cy, w, h, angle) boxes; returns the
    keep mask."""
    if valid is None:
        valid = torch.ones(boxes.shape[0], dtype=torch.bool,
                           device=boxes.device)
    return _nms_from_iou(rbbox_iou(boxes, boxes), scores, valid, thresh)
