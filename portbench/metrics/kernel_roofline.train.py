"""``kernel_roofline.serve``'s reading, over the training cell's traced window."""
from pathlib import Path

from portbench import common

read = common.load_module(Path(__file__).with_name("kernel_roofline.serve.py"),
                          "portbench_metric_kernel_roofline_serve").read
