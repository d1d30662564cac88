"""Kernel 6's share of its roofline (``int8_resblock``, the whole int8
residual block): its calls' least time (``work.py``: the slower of its
operations over the peaks and its bytes over 3.35 TB/s) over the device time
they enqueued, as ``kernel_roofline.serve`` reads every kernel together.
At a width that is not a multiple of the conv's 256-row N tile (BaseModel
B's 268) the tail tile's own launches read as a lower share."""


def read(s):
    k = s.kernels.get("int8_resblock")
    if not k or not k["calls"] or k["device_s"] <= 0:
        return None
    return 100.0 * k["least_s"] / k["device_s"]
