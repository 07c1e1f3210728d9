"""Synthetic prob-map scenes shared by the PyTorch port's tests (numpy
only). Each returns (prob (H, W) float32, thresh, box_thresh): the cases of
``test_pallas_ops.py`` and ``test_postprocess_metrics.py``."""

import numpy as np


def draw_rot_rect(prob, cx, cy, w, h, deg, val=0.95):
    th = np.deg2rad(deg)
    ys, xs = np.mgrid[0:prob.shape[0], 0:prob.shape[1]]
    dx, dy = xs - cx, ys - cy
    u = dx * np.cos(th) + dy * np.sin(th)
    v = -dx * np.sin(th) + dy * np.cos(th)
    prob[(np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)] = val


def rot_rect():
    prob = np.zeros((160, 160), np.float32)
    draw_rot_rect(prob, 40, 40, 50, 14, 20)
    draw_rot_rect(prob, 110, 100, 60, 16, -35)
    draw_rot_rect(prob, 40, 120, 30, 12, 0)
    return prob, 0.3, 0.7


def serpentine():
    """A 640² spiral: one winding component."""
    prob = np.zeros((640, 640), np.float32)
    th = np.linspace(0, 6 * np.pi, 4000)
    r = 10 + th * 8
    for x, y in zip((320 + r * np.cos(th)).astype(int),
                    (320 + r * np.sin(th)).astype(int)):
        if 4 <= x < 636 and 4 <= y < 636:
            prob[y - 3:y + 4, x - 3:x + 4] = 0.9
    return prob, 0.3, 0.7


def speckles():
    """6 text-like rects among 140 speckles above thresh."""
    rng = np.random.RandomState(1)
    prob = np.zeros((320, 320), np.float32)
    for _ in range(6):
        draw_rot_rect(prob, rng.randint(40, 280), rng.randint(40, 280), 50,
                      12, rng.uniform(-40, 40), val=0.9)
    for _ in range(140):
        x, y = rng.randint(2, 318), rng.randint(2, 318)
        prob[y:y + 2, x:x + 2] = np.maximum(prob[y:y + 2, x:x + 2], 0.4)
    return prob, 0.25, 0.5


def empty():
    return np.zeros((64, 64), np.float32), 0.3, 0.7


def low_score():
    return rot_rect()[0] * 0.4, 0.3, 0.7


def nested_ring():
    """A ring at .55 with a .95 blob nested in its hole."""
    prob = np.full((128, 128), 0.05, np.float32)
    prob[30:90, 30:90] = 0.55
    prob[42:78, 42:78] = 0.05
    prob[54:66, 54:66] = 0.95
    return prob, 0.3, 0.7


def diagonal_hole():
    """A hole sealed only by a 1-px diamond of diagonal steps."""
    prob = np.full((64, 64), 0.05, np.float32)
    cy, cx, r = 32, 32, 12
    for i in range(r + 1):
        for sy, sx in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            prob[cy - r * sy + i * sy, cx + i * sx] = 0.8
    return prob, 0.3, 0.1


SCENES = {"rot_rect": rot_rect, "serpentine": serpentine,
          "speckles": speckles, "empty": empty, "low_score": low_score,
          "nested_ring": nested_ring, "diagonal_hole": diagonal_hole}


# Tolerances of the port against the JAX cc.py. The JAX version sums in f32
# by scatter, the port exactly (int64 coordinates) or in f64. On the
# serpentine's one 14k-pixel component the f32 sums move the JAX score by
# ~1e-4 and turn its PCA angle, and so the searched angles, by ~1e-5 rad:
# 3e-3 px at corners 300 px from the centre. Elsewhere the components are
# small and the defaults hold.
def corner_tol(scene):
    return {"serpentine": 5e-3}.get(scene, 1e-3)     # px


def score_tol(scene):
    return {"serpentine": 2e-4}.get(scene, 1e-5)
