"""The port's tests' shared predictor: a deterministic float64 numpy MLP
that both packages can schedule with."""
import numpy as np


class NumpyPredictor:
    """A deterministic float64 numpy MLP with float32 answers, one per GPU
    type: both packages schedule with the same object, so the matching can
    not flip on one framework's fp32 rounding."""

    def __init__(self, seed: int = 0, gpu_types=("T4", "A10", "A100")):
        rng = np.random.default_rng(seed)
        self.params_by_type = {
            t: (rng.standard_normal((9, 16)), rng.standard_normal(16),
                rng.standard_normal(16)) for t in gpu_types}

    def predict(self, gpu_type, feats):
        w1, b1, w2 = self.params_by_type[gpu_type]
        h = np.maximum(np.asarray(feats, np.float64) @ w1 + b1, 0.0)
        return (1.0 / (1.0 + np.exp(-(h @ w2) / 4.0))).astype(np.float32)
