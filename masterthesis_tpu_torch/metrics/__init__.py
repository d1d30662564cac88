"""FID (InceptionV3) and LPIPS (AlexNet), the metrics ``evaluate`` reports."""
from masterthesis_tpu_torch.metrics.fid import FID, compute_fid_from_dirs, fid_score  # noqa: F401
from masterthesis_tpu_torch.metrics.lpips import LPIPS, compute_lpips_from_dirs, make_lpips_fn  # noqa: F401
from masterthesis_tpu_torch.metrics.metrics import Metrics  # noqa: F401
