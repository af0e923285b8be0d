"""2D polygon helpers (reference: utils/wheatgs_helper.py:30-66, which uses
shapely; convex-polygon math is implemented directly).

A numpy copy of wheat3dgs_tpu/utils/geometry2d.py."""

from __future__ import annotations

import numpy as np


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of an (N, 2) polygon."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def clip_convex(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: intersection of two convex polygons (N, 2)."""

    def ccw(p):
        return polygon_area_signed(p) > 0

    def polygon_area_signed(p):
        x, y = p[:, 0], p[:, 1]
        return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    clip = clip if ccw(clip) else clip[::-1]
    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        input_pts, output = output, []
        if not input_pts:
            break
        edge = b - a

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0

        def intersect(p, q):
            d = q - p
            denom = edge[0] * d[1] - edge[1] * d[0]
            t = (edge[0] * (a[1] - p[1]) - edge[1] * (a[0] - p[0])) / denom
            return p + t * d

        for j in range(len(input_pts)):
            p, q = input_pts[j], input_pts[(j + 1) % len(input_pts)]
            if inside(q):
                if not inside(p):
                    output.append(intersect(p, q))
                output.append(q)
            elif inside(p):
                output.append(intersect(p, q))
    return np.asarray(output).reshape(-1, 2)


def intersection_area(poly_a: np.ndarray, poly_b: np.ndarray) -> float:
    inter = clip_convex(np.asarray(poly_a, float), np.asarray(poly_b, float))
    return polygon_area(inter) if len(inter) >= 3 else 0.0


def polygon_distance(poly_a: np.ndarray, poly_b: np.ndarray) -> float:
    """Min vertex-to-edge distance between two polygons (0 if overlapping)."""
    if intersection_area(poly_a, poly_b) > 0:
        return 0.0

    def pt_seg(p, a, b):
        d = b - a
        t = np.clip(np.dot(p - a, d) / max(np.dot(d, d), 1e-12), 0, 1)
        return np.linalg.norm(p - (a + t * d))

    best = np.inf
    for p1, p2 in ((poly_a, poly_b), (poly_b, poly_a)):
        for p in p1:
            for i in range(len(p2)):
                best = min(best, pt_seg(p, p2[i], p2[(i + 1) % len(p2)]))
    return float(best)


def find_best_match(query_rect_points, list_of_rect_points):
    """Rectangle with the largest overlap with the query (fallback: nearest)
    — reference find_best_match (utils/wheatgs_helper.py:35-66)."""
    query = np.asarray(query_rect_points, float)
    best_match, matched_idx, max_area = None, None, 0.0
    for i, cand in enumerate(list_of_rect_points):
        area = intersection_area(query, np.asarray(cand, float))
        if area > max_area:
            max_area, best_match, matched_idx = area, cand, i
    if max_area == 0.0:
        min_dist = np.inf
        for i, cand in enumerate(list_of_rect_points):
            d = polygon_distance(query, np.asarray(cand, float))
            if d < min_dist:
                min_dist, best_match, matched_idx = d, cand, i
    return best_match, matched_idx


def nearest_k_viewpoints(query_center: np.ndarray, centers: np.ndarray,
                         k: int = 5) -> np.ndarray:
    """Indices of the k camera centers nearest to the query
    (reference get_nearest_viewpoints, utils/wheatgs_helper.py:102-117)."""
    d = np.linalg.norm(np.asarray(centers) - np.asarray(query_center)[None],
                       axis=1)
    return np.argsort(d)[:k]
