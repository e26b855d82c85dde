"""Plain reference of the modality-aware scores (paper 3.1), in NumPy
float64, for the check of ``correct``.

Image (3.1.1): resolution, edge density (mean Sobel magnitude), texture
entropy (256-bin gray histogram) and sharpness (variance of the
Laplacian), each on an edge-replicated border and normalised as the paper
states, weighted equally. Text (3.1.2): token length against L0 and
entities per sentence against gamma, weighted equally, from the token
classes of the prompt's ids. The constants are the paper's defaults as the
program's ``ComplexityConfig`` states them; they are copied here, not
imported.
"""
from __future__ import annotations

import numpy as np

# ComplexityConfig defaults
W_RES = W_EDGE = W_ENT = W_LAP = 0.25
REF_PIXELS = 1024 * 1024
EDGE_P5, EDGE_P95 = 2.0, 60.0
LAP_P5, LAP_P95 = 10.0, 2500.0
EPS = 1e-6
BETA_LEN = BETA_NER = 0.5
LEN_L0 = 512
NER_GAMMA = 4.0
# toy tokenizer classes
SENT_END_ID = 3
ENTITY_BASE, ENTITY_RANGE = 4, 996
PAD_ID = 0


def image_score(img: np.ndarray) -> float:
    x = np.asarray(img, np.float64)
    h, w = x.shape
    p = np.pad(x, 1, mode="edge")
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    gy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[:-2, 1:-1] - p[:-2, 2:])
    lap = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * x
    n = float(h * w)
    c_edge = np.clip((np.sqrt(gx * gx + gy * gy).sum() / n - EDGE_P5)
                     / (EDGE_P95 - EDGE_P5 + EPS), 0.0, 1.0)
    lap_var = (lap * lap).sum() / n - (lap.sum() / n) ** 2
    c_lap = np.clip((lap_var - LAP_P5) / (LAP_P95 - LAP_P5 + EPS), 0.0, 1.0)
    bins = np.clip(np.floor(x), 0, 255).astype(np.int64)
    prob = np.bincount(bins.ravel(), minlength=256) / n
    prob = prob[prob > 0]
    c_ent = -(prob * np.log(prob)).sum() / np.log(256.0)
    c_res = min(1.0, n / REF_PIXELS)
    return float(W_RES * c_res + W_EDGE * c_edge + W_ENT * c_ent
                 + W_LAP * c_lap)


def text_score(ids: np.ndarray) -> float:
    ids = np.asarray(ids)
    ids = ids[ids != PAD_ID]
    n_ent = int(((ids >= ENTITY_BASE)
                 & (ids < ENTITY_BASE + ENTITY_RANGE)).sum())
    n_sent = max(1, int((ids == SENT_END_ID).sum()))
    c_len = min(len(ids) / LEN_L0, 1.0)
    c_ner = min((n_ent / n_sent) / NER_GAMMA, 1.0)
    return float(BETA_LEN * c_len + BETA_NER * c_ner)
