"""``idle_share.serve``'s reading, over the training cell's traced window."""
from pathlib import Path

from portbench import common

read = common.load_module(Path(__file__).with_name("idle_share.serve.py"),
                          "portbench_metric_idle_share_serve").read
