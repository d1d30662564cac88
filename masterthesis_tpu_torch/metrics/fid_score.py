"""FID score API alias.

The reference ships a duplicate FID implementation (src/metrics/fid_score.py:58-157
alongside src/metrics/fid.py); as in the JAX package, both entry points share
the single streaming implementation in metrics.fid.
"""
from masterthesis_tpu_torch.metrics.fid import FID, compute_fid_from_dirs, fid_score  # noqa: F401
