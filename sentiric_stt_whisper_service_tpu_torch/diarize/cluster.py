"""Online speaker clustering over 8-D prosody vectors.

A copy of the JAX package's ``diarize/cluster.py``: the reference service's
``SpeakerClusterer`` (its speaker_cluster.cpp:19-40), nearest-centroid cosine
similarity, assign when sim ≥ threshold (default 0.88,
config.h:71) with running-mean centroid update, else a new ``spk_N``.
Instantiated per request — identities do not persist across requests
(the reference's stt_engine.cpp:202).

The similarity scan is vectorized (one [n_clusters, 8] matvec per assign);
the assign-or-add control flow stays on the host (data-dependent, tiny N).
"""

from __future__ import annotations

import numpy as np


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Reference semantics (speaker_cluster.cpp `cosine`): 0 when either
    vector has zero norm."""
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


class SpeakerClusterer:
    def __init__(self, threshold: float = 0.88):
        self.threshold = float(threshold)
        self._centroids: list[np.ndarray] = []
        self._counts: list[int] = []

    @property
    def n_clusters(self) -> int:
        return len(self._centroids)

    def assign_or_add(self, vec) -> str:
        vec = np.asarray(vec, np.float32).reshape(-1)
        if self._centroids:
            cents = np.stack(self._centroids)  # [N, 8]
            norms = np.linalg.norm(cents, axis=1) * (np.linalg.norm(vec) or 1.0)
            sims = np.where(
                (norms > 0) & (np.linalg.norm(vec) > 0),
                cents @ vec / np.maximum(norms, 1e-30),
                0.0,
            )
            best = int(np.argmax(sims))
            if sims[best] >= self.threshold:
                # Running-mean centroid update (speaker_cluster.cpp:28-33).
                n = self._counts[best]
                self._centroids[best] = (self._centroids[best] * n + vec) / (n + 1)
                self._counts[best] = n + 1
                return f"spk_{best}"
        self._centroids.append(vec.copy())
        self._counts.append(1)
        return f"spk_{len(self._centroids) - 1}"
