"""Kernel 5's share of its roofline (``int8_deconv``, the int8 k3/s2
transposed conv): its calls' least time (``work.py``: the slower of its
operations over the peaks and its bytes over 3.35 TB/s) over the device time
they enqueued, as ``kernel_roofline.serve`` reads every kernel together.
Phase rows that are not a multiple of the 128-row N tile (BaseModel B's 552
and 292) add a tail launch each and read as a lower share."""


def read(s):
    k = s.kernels.get("int8_deconv")
    if not k or not k["calls"] or k["device_s"] <= 0:
        return None
    return 100.0 * k["least_s"] / k["device_s"]
