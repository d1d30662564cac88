"""Tools: weight carry-over from the JAX package and the original, the metric
CLIs (``compute_fid``, ``compute_lpips``), pretrained-weight conversion
(``convert_weights``), frame extraction (``extract``) and video I/O."""
